"""The Qwen3 family (dense GQA decoder with qk-norm): how a configuration
file's keys map onto the port's ``ModelConfig``, how the benchmark's
weights are initialised, the plain reference's loss, and the model
FLOPs of training.

Model FLOPs (forward and backward, recomputation not counted): a matmul
of an (n, a) operand with an (a, b) weight costs 2 n a b in the forward
and twice that in the backward, so each matmul weight costs 6 FLOPs a
token.  The embedding lookup is no matmul and is not counted; the output
head is.  Attention adds the scores Q K^T and the weighted sum P V: 2 x 2
S (heads x head_dim) a token a layer forward, x 3 with the backward,
12 L H hd S a token (every pair of the S x S matrix, as PaLM's
model-FLOPs count takes it).
"""

from __future__ import annotations

from reference import qwen3 as model

# the file's key -> the port's ModelConfig field
FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "num_attention_heads": "num_heads",
          "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
          "vocab_size": "vocab_size", "rms_norm_eps": "norm_eps",
          "rope_theta": "rope_theta",
          "tie_word_embeddings": "tie_embeddings",
          "activation_dtype": "act_dtype"}

# leaf (last part of its dotted name) -> constant, or the std of N(0, std^2)
CONSTANT = {"ln1": 1.0, "ln2": 1.0, "ln_f": 1.0, "q_norm": 1.0,
            "k_norm": 1.0}
SCALE = {"embed": 0.02}

loss = model.loss


def init_rule(name: str, shape) -> tuple:
    """("const", value) or ("normal", std): embeddings N(0, 0.02^2), a
    matmul weight of fan-in f N(0, 1/f), norm weights 1."""
    base = name.rsplit(".", 1)[-1]
    if base in CONSTANT:
        return "const", CONSTANT[base]
    return "normal", SCALE.get(base, shape[-2] ** -0.5)


def matmul_weights(conf: dict) -> int:
    d, f = conf["hidden_size"], conf["intermediate_size"]
    h, kv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    per_layer = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    return conf["num_hidden_layers"] * per_layer + d * conf["vocab_size"]


def train_flops_per_token(conf: dict, seq: int) -> int:
    attn = 12 * conf["num_hidden_layers"] * conf["num_attention_heads"] \
        * conf["head_dim"] * seq
    return 6 * matmul_weights(conf) + attn
