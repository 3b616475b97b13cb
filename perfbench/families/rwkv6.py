"""The RWKV6 (Finch) family, attention-free: how a configuration file's
keys map onto the port's ``ModelConfig``, how the benchmark's weights
are initialised, the plain reference's loss, and the model FLOPs of
training.

Model FLOPs (forward and backward, recomputation not counted): 6 FLOPs a
token for each matmul weight (the embedding lookup not counted, the head
counted), and the WKV recurrence in its state form: a token reads the
(hd x hd) state of each head (2 hd^2) and adds k v^T to it (2 hd^2),
4 D hd a token a layer forward, x 3 with the backward.
"""

from __future__ import annotations

from reference import rwkv6 as model

# the file's key -> the port's ModelConfig field
FIELDS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
          "head_size": "ssm_head_dim", "vocab_size": "vocab_size",
          "rms_norm_eps": "norm_eps",
          "tie_word_embeddings": "tie_embeddings",
          "activation_dtype": "act_dtype"}

# leaf (last part of its dotted name) -> constant, or the std of N(0, std^2)
CONSTANT = {"ln0": 1.0, "ln1": 1.0, "ln2": 1.0, "ln_f": 1.0, "ln_w": 1.0,
            "w0": -5.5, "bonus": 0.0}
SCALE = {"embed": 0.02, "w_a": 0.01, "w_b": 0.01}

loss = model.loss


def init_rule(name: str, shape) -> tuple:
    """("const", value) or ("normal", std): embeddings N(0, 0.02^2), the
    decay LoRA N(0, 0.01^2), a matmul weight of fan-in f N(0, 1/f); norm
    weights 1, token shifts 0.5, the decay base -5.5, the bonus 0."""
    base = name.rsplit(".", 1)[-1]
    if base in CONSTANT:
        return "const", CONSTANT[base]
    if base.startswith("mu_"):
        return "const", 0.5
    return "normal", SCALE.get(base, shape[-2] ** -0.5)


def matmul_weights(conf: dict) -> int:
    d, f, lora = (conf["hidden_size"], conf["intermediate_size"],
                  conf["decay_lora_rank"])
    time_mix = 5 * d * d + 2 * d * lora
    channel_mix = 2 * d * f + d * d
    return conf["num_hidden_layers"] * (time_mix + channel_mix) \
        + d * conf["vocab_size"]


def train_flops_per_token(conf: dict, seq: int) -> int:
    wkv = 3 * 4 * conf["num_hidden_layers"] * conf["hidden_size"] \
        * conf["head_size"]
    return 6 * matmul_weights(conf) + wkv
