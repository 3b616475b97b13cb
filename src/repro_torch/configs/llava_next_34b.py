"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 -- anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf family].

Backbone only: the SigLIP/ViT tower + projector is a stub; input_specs
provides (B, P, D) patch embeddings, P=2880 (anyres: 5 tiles x 576).
Prefix tokens count against the sequence budget of each input shape.
"""
import dataclasses
from repro_torch.configs.base import ArchConfig, ModelConfig, ParallelConfig

MODEL = ModelConfig(
    name="llava-next-34b", arch_type="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    num_prefix_tokens=2880,
    act_dtype="bfloat16", q_chunk=128,
)

CONFIG = ArchConfig(
    model=MODEL,
    parallel=ParallelConfig(fsdp=True, microbatches=8, aggregation="rs_mm"),
)

def smoke_config():
    return dataclasses.replace(
        MODEL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, num_prefix_tokens=8,
        act_dtype="float32", q_chunk=1024)
