"""The frozen counts against the program's own model of them, at each
cell's shapes, and the model FLOPs of a step written out."""

import pytest

from counts import mm_ops
from harness import common, portcfg

BENCH = common.benchmark()


PB = common.ROOT / "perfbench"
# the train traffic's pairs that have no cell yet (PERF.md)
TRAIN_PAIRS = (("qwen3-0.6b", "train-k8"), ("rwkv6-1.6b", "train-k4"))


def _shapes():
    """(cell, K, M, weighted) of every MM launch a cell makes."""
    out = []
    for w in BENCH["workloads"]:
        c = common.cell(BENCH, w["name"])
        out.append((w["name"], c["traffic"]["k_min"],
                    c["config"]["parameters"], True))
    for conf, traffic in TRAIN_PAIRS:
        data = common.load_json(PB / "configs" / f"{conf}.json")
        cfg = portcfg.model_config(data, common.family(
            {"root": common.ROOT, "config": data}))
        k = common.load_json(PB / "traffic" / f"{traffic}.json")["agents"]
        for n, s in portcfg.leaf_shapes(cfg).items():
            m = 1
            for d in s:
                m *= d
            out.append((f"{conf}.{traffic}:{n}", k, m, False))
    return out


@pytest.mark.parametrize("cell,k,m,weighted", _shapes(),
                         ids=lambda v: str(v))
def test_frozen_ops_equal_the_programs_model(cell, k, m, weighted):
    from repro_torch.kernels import mm_aggregate
    assert mm_ops.ops(k, m, 1, weighted) == mm_aggregate.modeled_ops(
        k, m, 1, weighted)


def test_serve_bounds():
    t, by = mm_ops.bound_s(8, 751_894_528, 1, True)
    assert by == "ops" and abs(t * 1e3 - 9.86) < 0.01
    t, by = mm_ops.bound_s(128, 15_730_944, 1, True)
    assert by == "ops"


def _family(conf: dict):
    return common.family({"root": common.ROOT, "config": conf})


def test_model_flops():
    qwen = common.load_json(common.ROOT / "perfbench/configs/qwen3-0.6b.json")
    rwkv = common.load_json(common.ROOT / "perfbench/configs/rwkv6-1.6b.json")
    fq, fr = _family(qwen), _family(rwkv)
    assert fq.matmul_weights(qwen) == 595_984_384
    assert fq.train_flops_per_token(qwen, 1024) * 8 * 1024 \
        == 35_066_260_488_192
    assert fr.matmul_weights(rwkv) == 1_449_132_032
    assert fr.train_flops_per_token(rwkv, 1024) * 4 * 1024 \
        == 35_768_487_641_088


@pytest.mark.parametrize("path", sorted((PB / "configs").glob("*.json")),
                         ids=lambda p: p.name)
def test_config_parameters_are_the_ports_payload(path):
    """A serve run takes a payload of the configuration's ``parameters``
    coordinates; that number is the port's parameter tree (``payload``
    "model") or one decoder layer of it ("decoder_layer")."""
    conf = common.load_json(path)
    assert portcfg.payload_size(conf, _family(conf)) == conf["parameters"]
