"""StarCoder2-15B — GQA, RoPE [arXiv:2402.19173; hf].
40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-15b", family="dense",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152, act="gelu", gated_mlp=False, rope_theta=1e5,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=131072,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                       head_dim=8, d_ff=128, vocab_size=512,
                       param_dtype="float32", compute_dtype="float32",
                       remat=False, block_size=8, max_seq_len=2048)
