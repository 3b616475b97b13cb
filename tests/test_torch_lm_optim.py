"""The port's optimizers, token streams, checkpoints, ``apply_tree`` and
``engine_aggregator`` against the JAX reference (CPU), on identical
numpy inputs.

Tolerances: one SGD or momentum update at atol 1e-7 (the same f32
arithmetic); Adam's moments at rtol 1e-6 and its parameters at atol
1e-6 (the bias corrections are computed in float32 numpy on the host,
the reference's in float32 on the device); the schedule at rtol 1e-6.
Token streams and checkpoints are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import attacks as jatt
from repro.core import sharded as jsharded
from repro.data import synthetic as jsyn
from repro.models import model as JM
from repro.optim import optimizers as JO
from repro_torch import interop, pytree
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import attacks as tatt
from repro_torch.core import sharded as tsharded
from repro_torch.data import synthetic as tsyn
from repro_torch.models import model as TM
from repro_torch.optim import optimizers as TO


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = {"a": rng.normal(size=(3, 4)).astype(np.float32) * 2,
             "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    return params, grads


def _leaves_np(tree):
    return [interop.to_numpy(t) for t in pytree.flatten(tree)[0]]


def _jleaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("name,clip,state_dtype", [
    ("sgd", 0.0, "float32"), ("momentum", 1.0, "float32"),
    ("adam", 1.0, "float32"), ("adam", 0.0, "bfloat16")])
def test_optimizer_updates_match(name, clip, state_dtype):
    params, grads = _trees()
    kw = dict(name=name, learning_rate=0.1, grad_clip=clip, warmup_steps=3,
              total_steps=20, state_dtype=state_dtype, weight_decay=0.01)
    jcfg, tcfg = JO.OptimizerConfig(**kw), TO.OptimizerConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = interop.from_numpy_tree(params, "cpu")
    jst, tst = JO.init(jcfg, jp), TO.init(tcfg, tp)
    for step in range(3):
        g = jax.tree.map(lambda x, s=step: x * (1 + s), grads)
        jp, jst = JO.update(jcfg, jp, jax.tree.map(jnp.asarray, g), jst)
        tp, tst = TO.update(tcfg, tp, interop.from_numpy_tree(g, "cpu"), tst)
    assert tst.step == int(jst.step) == 3
    atol = 1e-6 if name == "adam" else 1e-7
    for a, b in zip(_leaves_np(tp), _jleaves(jp)):
        np.testing.assert_allclose(a, b, atol=atol)
    if name != "sgd":
        for a, b in zip(_leaves_np(tst.m), _jleaves(jst.m)):
            np.testing.assert_allclose(a, b, rtol=1e-6 if state_dtype ==
                                       "float32" else 2 ** -7, atol=1e-7)
    if name == "adam":
        assert pytree.flatten(tst.v)[0][0].dtype == getattr(torch, state_dtype)
        for a, b in zip(_leaves_np(tst.v), _jleaves(jst.v)):
            np.testing.assert_allclose(a, b, rtol=1e-6 if state_dtype ==
                                       "float32" else 2 ** -7, atol=1e-9)


@pytest.mark.parametrize("kind", ["cosine", "constant"])
def test_schedule_global_norm_and_clip_match(kind):
    cfg = dict(learning_rate=3e-3, warmup_steps=10, total_steps=100,
               schedule_kind=kind)
    for step in (0, 5, 9, 10, 40, 99, 150):
        np.testing.assert_allclose(
            TO.schedule(TO.OptimizerConfig(**cfg), step),
            float(JO.schedule(JO.OptimizerConfig(**cfg), jnp.asarray(step))),
            rtol=1e-6)
    _, grads = _trees(1)
    tg = interop.from_numpy_tree(grads, "cpu")
    jg = jax.tree.map(jnp.asarray, grads)
    np.testing.assert_allclose(float(TO.global_norm(tg)),
                               float(JO.global_norm(jg)), rtol=1e-6)
    for a, b in zip(_leaves_np(TO.clip_by_global_norm(tg, 1.0)),
                    _jleaves(JO.clip_by_global_norm(jg, 1.0))):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert TO.clip_by_global_norm(tg, 0.0) is tg
    with pytest.raises(ValueError, match="schedule_kind"):
        TO.schedule(TO.OptimizerConfig(schedule_kind="linear"), 1)


def test_token_stream_is_the_reference_stream():
    kw = dict(vocab_size=997, seq_len=24, batch_size=3, seed=5)
    js = jsyn.token_batches(jsyn.TokenStreamConfig(**kw))
    ts = tsyn.token_batches(tsyn.TokenStreamConfig(**kw))
    for _ in range(3):
        a, b = next(js)["tokens"], next(ts)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tsyn._zipf_probs(50), jsyn._zipf_probs(50))
    g = torch.Generator().manual_seed(0)
    batch = tsyn.make_lm_batch(g, 4, 7, 33, device="cpu")
    t = batch["tokens"]
    assert t.shape == (4, 8) and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < 33


def test_lm_loss_masks_negative_labels_like_the_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    np.testing.assert_allclose(
        float(TM.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                         aux=torch.tensor(0.5), aux_weight=0.01)),
        float(JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                         aux=0.5, aux_weight=0.01)), rtol=1e-6)


def test_checkpoints_restore_across_packages(tmp_path):
    params, grads = _trees(3)
    jp = jax.tree.map(jnp.asarray, params)
    jst = JO.init(JO.OptimizerConfig(), jp)
    jst = JO.update(JO.OptimizerConfig(), jp, jax.tree.map(jnp.asarray, grads),
                    jst)[1]
    # JAX writes, the port restores (params and an Adam state)
    jckpt.save(str(tmp_path / "j"), {"params": jp, "opt": jst}, step=7)
    tp = interop.from_numpy_tree(params, "cpu")
    like = {"params": pytree.tree_map(torch.zeros_like, tp),
            "opt": TO.init(TO.OptimizerConfig(), tp)}
    got = tckpt.restore(str(tmp_path / "j"), like)
    assert tckpt.latest_step(str(tmp_path / "j")) == 7
    assert isinstance(got["opt"], TO.AdamState) and got["opt"].step == 1
    for a, b in zip(_leaves_np(got["params"]), _jleaves(jp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_leaves_np(got["opt"].v), _jleaves(jst.v)):
        np.testing.assert_array_equal(a, b)
    # the port writes, JAX restores
    tckpt.save(str(tmp_path / "t"), {"params": tp}, step=3)
    back = jckpt.restore(str(tmp_path / "t"), {"params": jp})
    for a, b in zip(_jleaves(back), _leaves_np(tp)):
        np.testing.assert_array_equal(a, b)
    assert jckpt.latest_step(str(tmp_path / "t")) == 3
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path / "t"),
                      {"params": {"a": torch.zeros(2), "b": {"c": torch.zeros(5)}}})


def test_apply_tree_and_engine_aggregator_match():
    rng = np.random.default_rng(4)
    tree = {"w": rng.normal(size=(6, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(6, 5)).astype(np.float32)}
    for attack, kw in (("additive", (("delta", 100.0),)),
                       ("sign_flip", ()), ("alie", ())):
        jb = jatt.ByzantineConfig(num_malicious=2, attack=attack,
                                  attack_kwargs=kw)
        tb = tatt.ByzantineConfig(num_malicious=2, attack=attack,
                                  attack_kwargs=kw)
        want = jb.apply_tree(jax.tree.map(jnp.asarray, tree),
                             jax.random.key(0), 0)
        got = tb.apply_tree(interop.from_numpy_tree(tree, "cpu"), None, 0)
        for a, b in zip(_leaves_np(got), _jleaves(want)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        # a list of leaves (the train step's stacks) is corrupted in place
        stacks = [torch.from_numpy(tree[key]) for key in sorted(tree)]
        honest = list(stacks)
        assert tb.apply_tree(stacks, None, 0) is stacks
        assert all(s is not h for s, h in zip(stacks, honest))
        for a, b in zip(stacks, _jleaves(want)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6)
    x = tree["w"].reshape(6, -1)
    x[-2:] += 1000.0
    for name, backend in (("mm_tukey", None), ("mm_pallas", None),
                          ("mm_tukey", "pallas"), ("median", None)):
        want = jsharded.engine_aggregator(name, backend=backend)(
            jnp.asarray(x), None) if name != "median" else \
            jsharded.engine_aggregator(name)(jnp.asarray(x), None)
        agg = tsharded.engine_aggregator(name, backend=backend) \
            if name != "median" else tsharded.engine_aggregator(name)
        np.testing.assert_allclose(interop.to_numpy(agg(torch.from_numpy(x), None)),
                                   np.asarray(want), atol=1e-5, rtol=1e-6)
