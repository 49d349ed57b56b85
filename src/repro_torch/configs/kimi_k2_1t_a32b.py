"""Kimi K2 — trillion-parameter MoE [arXiv:2501.kimi2; unverified].
61L d_model=7168 64H (GQA kv=8) MoE 384 experts top-8, expert d_ff=2048,
vocab 163840."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, moe_d_ff=2048, n_experts=384, top_k=8,
    vocab_size=163840, act="silu", rope_theta=5e4,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=131072,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                       head_dim=8, moe_d_ff=32, d_ff=32, n_experts=8,
                       top_k=2, vocab_size=512, param_dtype="float32",
                       compute_dtype="float32", remat=False, block_size=8,
                       max_seq_len=2048)
