"""SmolLM-135M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf].
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152, act="silu", rope_theta=1e4,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=131072,
)

SMOKE = CONFIG.replace(n_layers=3, d_model=48, n_heads=6, n_kv_heads=3,
                       head_dim=8, d_ff=96, vocab_size=512, block_size=8,
                       param_dtype="float32", compute_dtype="float32",
                       remat=False, max_seq_len=2048)
