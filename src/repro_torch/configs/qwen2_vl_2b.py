"""Qwen2-VL-2B — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].
28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
The vision frontend is a STUB: input_specs provide precomputed patch
embeddings; only the transformer backbone is modeled (per assignment)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, act="silu", rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=131072,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab_size=512,
                       mrope_sections=(2, 3, 3), param_dtype="float32",
                       compute_dtype="float32", remat=False, block_size=8,
                       max_seq_len=2048)
