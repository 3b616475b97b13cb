"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 -- enc-dec, multimodal [arXiv:2308.11596].

Backbone only: the mel-spectrogram + conv feature extractor frontend is
a stub; input_specs provides (B, F, D) frame embeddings (F=1024).
24 encoder + 24 decoder layers (w2v-BERT encoder / NLLB-style decoder).
"""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="seamless-m4t-large-v2", arch_type="audio",
    num_layers=24, encoder_layers=24,
    d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206,
    mlp_gated=False,              # classic transformer FFN (8x, GELU)
    num_prefix_tokens=1024,       # stub audio frames
    act_dtype="bfloat16", q_chunk=512,
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=False, microbatches=2, aggregation="rs_mm"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=2, encoder_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        num_prefix_tokens=16, act_dtype="float32", q_chunk=1024)
