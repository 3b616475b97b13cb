"""qwen3-0.6b [dense]: 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936 -- qk_norm, GQA, head_dim=128 [hf:Qwen/Qwen3-8B family]."""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="qwen3-0.6b", arch_type="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936, qk_norm=True,
    act_dtype="bfloat16", q_chunk=512,
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=False, microbatches=1, aggregation="rs_mm"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, act_dtype="float32",
        q_chunk=1024)
