"""Llama-3.2-1B [hf:meta-llama/Llama-3.2-1B; unverified].
16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256, act="silu", rope_theta=5e5,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=131072,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                       head_dim=8, d_ff=128, vocab_size=512,
                       param_dtype="float32", compute_dtype="float32",
                       remat=False, block_size=8, max_seq_len=2048)
