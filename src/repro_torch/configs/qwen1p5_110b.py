"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064 -- QKV bias [hf:Qwen/Qwen1.5-0.5B family]."""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="qwen1.5-110b", arch_type="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064, qkv_bias=True,
    act_dtype="bfloat16", q_chunk=512,
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=True, microbatches=16, aggregation="rs_mm"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=2, d_model=256, num_heads=8, num_kv_heads=2,
        head_dim=32, d_ff=512, vocab_size=512, act_dtype="float32",
        q_chunk=1024)
