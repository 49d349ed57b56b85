"""Llama-4 Scout 17B-active 16-expert MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].
48L d_model=5120 40H (GQA kv=8) d_ff=8192 MoE 16e top-1 vocab 202048."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, moe_d_ff=8192, n_experts=16, top_k=1,
    vocab_size=202048, act="silu", rope_theta=5e5,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=131072,
)

SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                       head_dim=8, d_ff=64, moe_d_ff=64, n_experts=4,
                       top_k=1, vocab_size=512, param_dtype="float32",
                       compute_dtype="float32", remat=False, block_size=8,
                       max_seq_len=2048)
