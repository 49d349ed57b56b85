"""Phi-3-medium-14B — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].
40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352, act="silu", rope_theta=1e4,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=131072,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=80, n_heads=10, n_kv_heads=5,
                       head_dim=8, d_ff=160, vocab_size=512,
                       param_dtype="float32", compute_dtype="float32",
                       remat=False, block_size=8, max_seq_len=2048)
