"""RWKV6 "Finch" 1.6B — attn-free, data-dependent decay
[arXiv:2404.05892; unverified].
24L d_model=2048 d_ff=7168 vocab=65536, head size 64 (32 heads).
Block-diffusion decoding is INAPPLICABLE (strictly causal recurrence — see
DESIGN.md §6); serves with native AR recurrent decode."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    rwkv_head_dim=64, rwkv_lora_rank=32, d_ff=7168, vocab_size=65536,
    act="silu", diffusion=False,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=1048576,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, rwkv_head_dim=16,
                       rwkv_lora_rank=8, d_ff=128, vocab_size=512,
                       param_dtype="float32", compute_dtype="float32",
                       remat=False, max_seq_len=2048)
