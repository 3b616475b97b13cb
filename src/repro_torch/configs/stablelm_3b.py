"""stablelm-3b [dense]: 32L d_model=2560 32H (GQA kv=32) d_ff=6912
vocab=50304 [hf:stabilityai/stablelm-2-1_6b family]."""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="stablelm-3b", arch_type="dense",
    num_layers=32, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=6912, vocab_size=50304,
    act_dtype="bfloat16", q_chunk=512,
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=False, microbatches=2, aggregation="rs_mm"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=512, act_dtype="float32",
        q_chunk=1024)
