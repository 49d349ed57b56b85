"""SeamlessM4T-large-v2 — enc-dec, multimodal [arXiv:2308.11596; hf].
24L (encoder) + 24L (decoder) d_model=1024 16H (kv=16, i.e. MHA)
d_ff=8192 vocab=256206.  The audio frontend is a STUB: input_specs provide
precomputed frame embeddings (per assignment)."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab_size=256206, act="gelu", gated_mlp=False, rope_theta=1e4,
    block_size=32, param_dtype="bfloat16", compute_dtype="bfloat16",
    remat=True, max_seq_len=32768,
    # vocab 256206 is not divisible by the 16-way model axis → replicate
    # the embedding/head instead of vocab-sharding (0.5 GiB, acceptable)
    rule_overrides=(("vocab_p", None), ("vocab", None)),
)

SMOKE = CONFIG.replace(n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
                       param_dtype="float32", compute_dtype="float32",
                       remat=False, block_size=8, max_seq_len=2048)
