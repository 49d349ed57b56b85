"""Jamba-1.5-Large 398B — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536; attention at
position 3 of every 8-layer period (real Jamba layout), MoE every other
layer, mamba d_state=16 d_conv=4 expand=2."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, moe_d_ff=24576, n_experts=16, top_k=2,
    attn_period=8, attn_offset=3, moe_every=2,
    d_state=16, d_conv=4, mamba_expand=2,
    vocab_size=65536, act="silu", rope_theta=1e4,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=1048576,
)

SMOKE = CONFIG.replace(n_layers=8, d_model=64, n_heads=8, n_kv_heads=2,
                       head_dim=8, d_ff=128, moe_d_ff=128, n_experts=4,
                       top_k=2, vocab_size=512, param_dtype="float32",
                       compute_dtype="float32", remat=False, block_size=8,
                       max_seq_len=2048)
