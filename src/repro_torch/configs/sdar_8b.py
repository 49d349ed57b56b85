"""SDAR-8B — the paper's main diffusion model (Qwen3-8B backbone adapted to
block diffusion, block size 32) [arXiv:2510.06303].
36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="sdar-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936, act="silu", rope_theta=1e6,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=131072,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                       head_dim=8, d_ff=128, vocab_size=512,
                       param_dtype="float32", compute_dtype="float32",
                       remat=False, block_size=8, max_seq_len=2048)
