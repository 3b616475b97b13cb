"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 -- Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

The single shared transformer block (attention + MLP, parameters shared
across applications) is applied every 6 Mamba2 layers (9 applications).
"""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    attn_every=6, chunk_size=128,
    act_dtype="bfloat16", q_chunk=512,
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=False, microbatches=2, aggregation="rs_mm"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        head_dim=32, d_ff=256, vocab_size=512, ssm_state=16, ssm_head_dim=32,
        attn_every=2, chunk_size=8, act_dtype="float32", q_chunk=1024)
