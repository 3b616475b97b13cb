"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family]."""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="qwen3-moe-235b-a22b", arch_type="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936, qk_norm=True,
    num_experts=128, experts_per_tok=8,
    act_dtype="bfloat16", q_chunk=512,
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=True, microbatches=16, aggregation="rs_mm",
                            opt_state_dtype="bfloat16"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=64, vocab_size=512, num_experts=4,
        experts_per_tok=2, act_dtype="float32", q_chunk=1024)
