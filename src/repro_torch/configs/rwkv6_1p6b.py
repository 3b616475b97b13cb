"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 -- Finch, data-dependent decay [arXiv:2404.05892]."""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="rwkv6-1.6b", arch_type="ssm",
    num_layers=24, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=7168, vocab_size=65536,
    ssm_head_dim=64, chunk_size=64,
    act_dtype="bfloat16",
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=False, microbatches=2, aggregation="rs_mm"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=2, d_model=128, d_ff=256, vocab_size=512,
        ssm_head_dim=32, chunk_size=8, act_dtype="float32")
