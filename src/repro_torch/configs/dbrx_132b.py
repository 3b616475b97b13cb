"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    num_experts=16, experts_per_tok=4,
    act_dtype="bfloat16", q_chunk=512,
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=True, microbatches=8, aggregation="rs_mm"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=96, vocab_size=512, num_experts=4,
        experts_per_tok=2, act_dtype="float32", q_chunk=1024)
