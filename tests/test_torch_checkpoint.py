"""The port's checkpoints (``repro_torch.checkpoint``) on the CPU: the
round trip of f32, bf16, int32, 0-d and host-integer leaves and of a
stacked leaf, bitwise; the atomic rename over a stale ``.tmp-step_``
directory; ``keep_last``; an asynchronous save followed by an in-place
update before ``wait()``; templates whose shape or dtype do not match;
and the reference's format both ways: the files of a tree saved by either
package are byte for byte the same, the port restores the reference's
checkpoint (bf16 leaf included), and the reference restores the port's.
The reference's own restore of a bf16 leaf raises (a fault of the
reference, recorded here).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "b": torch.randn(5, generator=g).to(torch.bfloat16),
                       "layers": [{"k": torch.randn(2, 2, generator=g)},
                                  {"k": torch.randn(2, 2, generator=g)}]},
            "opt": {"ids": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                    "scale": torch.tensor(0.5, dtype=torch.float64),
                    "count": 3},
            "stack": ckpt.Stacked([torch.randn(2, 3, generator=g)
                                   .to(torch.bfloat16) for _ in range(4)]),
            "step": 7}


def _flat(tree):
    out = {}
    for name, leaf in ckpt.leaves(tree):
        if isinstance(leaf, ckpt.Stacked):
            leaf = torch.stack(leaf.parts)
        out[name] = leaf
    return out


def _assert_bitwise(got, want):
    g, w = _flat(got), _flat(want)
    assert list(g) == list(w)
    for name in w:
        if isinstance(w[name], int):
            assert type(g[name]) is int and g[name] == w[name], name
        else:
            assert g[name].dtype == w[name].dtype, name
            assert torch.equal(g[name], w[name]), name


@pytest.mark.parametrize("blocking", [True, False])
def test_round_trip(tmp_path, blocking):
    """Every leaf comes back bitwise in its dtype; the manifest has the
    reference's fields, a 0-d int32 leaf for each host integer and
    "bfloat16" for bf16."""
    tree = _tree()
    final = ckpt.save(str(tmp_path), 7, tree, blocking=blocking,
                      extra={"arch": "x"}).wait()
    assert final == str(tmp_path / "step_00000007")
    assert ckpt.latest_step(str(tmp_path)) == 7
    with open(os.path.join(final, "manifest.json")) as f:
        man = json.load(f)
    assert set(man) == {"step", "leaves", "shard_index", "shard_count",
                        "extra"}
    assert (man["step"], man["shard_index"], man["shard_count"],
            man["extra"]) == (7, 0, 1, {"arch": "x"})
    dt = {e["name"]: (e["dtype"], e["shape"]) for e in man["leaves"]}
    assert dt["step"] == dt["opt__count"] == ("int32", [])
    assert dt["params__b"] == ("bfloat16", [5])
    assert dt["stack"] == ("bfloat16", [4, 2, 3])
    assert dt["params__layers__1__k"] == ("float32", [2, 2])
    got, step = ckpt.restore(str(tmp_path), _tree(seed=1))
    assert step == 7
    _assert_bitwise(got, tree)


def test_restore_into_in_place(tmp_path):
    """restore_into fills the template's own tensors (a stacked leaf part
    by part) and returns the host integers."""
    tree = _tree()
    ckpt.save(str(tmp_path), 2, tree, blocking=True)
    into = _tree(seed=1)
    into["step"] = into["opt"]["count"] = 0
    w, parts = into["params"]["w"], into["stack"].parts
    got, step = ckpt.restore_into(str(tmp_path), into)
    assert step == 2
    assert got["params"]["w"] is w and got["stack"].parts == parts
    _assert_bitwise(got, tree)


def test_stale_tmp_and_latest(tmp_path):
    """A stale .tmp-step_ directory (a crash during a save) is neither a
    step nor in the way: the next save of that step replaces it and
    renames atomically. A step directory without a manifest is not a
    step."""
    stale = tmp_path / ".tmp-step_00000005"
    stale.mkdir(parents=True)
    (stale / "junk.npy").write_bytes(b"partial")
    (tmp_path / "step_00000009").mkdir()          # no manifest
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save(str(tmp_path), 5, _tree(), blocking=True)
    assert not stale.exists()
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not (tmp_path / "step_00000005" / "junk.npy").exists()
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _tree())


def test_keep_last(tmp_path):
    """keep_last=2 leaves the two newest steps."""
    for step in range(1, 6):
        ckpt.save(str(tmp_path), step, {"x": torch.full((2,), step)},
                  keep_last=2).wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000004",
                                            "step_00000005"]


def test_async_save_then_in_place_step(tmp_path):
    """The leaves are copied to the host before save returns: updating
    them in place (as the optimizers do) before wait() changes nothing
    that is written."""
    tree = {"p": torch.randn(512, 512), "m": torch.zeros(512, 512),
            "stack": ckpt.Stacked([torch.ones(256, 256) for _ in range(3)]),
            "count": 1}
    want = {"p": tree["p"].clone(), "m": tree["m"].clone(),
            "stack": ckpt.Stacked([p.clone() for p in tree["stack"].parts]),
            "count": 1}
    h = ckpt.save(str(tmp_path), 1, tree)
    tree["p"].mul_(2.0).add_(1.0)
    tree["m"].add_(3.0)
    for p in tree["stack"].parts:
        p.zero_()
    tree["count"] = 2
    h.wait()
    assert h.seconds is not None
    got, _ = ckpt.restore(str(tmp_path), want)
    _assert_bitwise(got, want)


def test_template_mismatch(tmp_path):
    """A template leaf of another shape raises ValueError naming the leaf
    (restore and restore_into); restore_into also refuses another dtype;
    a leaf missing from the checkpoint raises KeyError."""
    ckpt.save(str(tmp_path), 1, _tree(), blocking=True)
    bad = _tree()
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="params__w"):
        ckpt.restore(str(tmp_path), bad)
    with pytest.raises(ValueError, match="params__w"):
        ckpt.restore_into(str(tmp_path), bad)
    bad = _tree()
    bad["params"]["b"] = torch.zeros(5)
    with pytest.raises(ValueError, match="params__b"):
        ckpt.restore_into(str(tmp_path), bad)
    bad = _tree()
    bad["params"]["extra"] = torch.zeros(1)
    with pytest.raises(KeyError, match="params__extra"):
        ckpt.restore(str(tmp_path), bad)


# ---------------------------------------------------------------------------
# the reference's format
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rck():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro import checkpoint
    return checkpoint, jnp


def _pair(jnp):
    """The same tree as the reference's (jax arrays, an int32 scalar) and
    the port's (tensors, a host int)."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal((2, 5)).astype(np.float32)
    ref = {"params": {"w": jnp.asarray(w),
                      "b": jnp.asarray(b).astype(jnp.bfloat16)},
           "step": jnp.int32(7)}
    port = {"params": {"w": torch.from_numpy(w),
                       "b": torch.from_numpy(b).to(torch.bfloat16)},
            "step": 7}
    return ref, port


def test_files_equal_the_references(tmp_path, rck):
    """The same tree saved by both packages: every leaf file (bf16
    included) byte for byte equal, and the manifests' entries equal."""
    checkpoint, jnp = rck
    ref, port = _pair(jnp)
    checkpoint.save(str(tmp_path / "r"), 7, ref, blocking=True)
    ckpt.save(str(tmp_path / "p"), 7, port, blocking=True)
    rd, pd = tmp_path / "r" / "step_00000007", tmp_path / "p" / "step_00000007"
    assert sorted(os.listdir(rd)) == sorted(os.listdir(pd))
    for name in os.listdir(rd):
        if name.endswith(".npy"):
            assert (rd / name).read_bytes() == (pd / name).read_bytes(), name
    rm, pm = (json.loads((d / "manifest.json").read_text()) for d in (rd, pd))
    assert sorted(rm["leaves"], key=lambda e: e["name"]) == sorted(
        pm["leaves"], key=lambda e: e["name"])
    assert {k: v for k, v in rm.items() if k != "leaves"} == {
        k: v for k, v in pm.items() if k != "leaves"}


def test_port_restores_the_references(tmp_path, rck):
    """A checkpoint written by the reference's save restores in the port
    bitwise, the bf16 leaf rebuilt from the manifest."""
    checkpoint, jnp = rck
    ref, port = _pair(jnp)
    checkpoint.save(str(tmp_path), 7, ref, blocking=True)
    got, step = ckpt.restore(str(tmp_path), {
        "params": {"w": torch.zeros(3, 4),
                   "b": torch.zeros(2, 5, dtype=torch.bfloat16)},
        "step": 0})
    assert step == 7
    _assert_bitwise(got, port)


def test_reference_restores_the_ports(tmp_path, rck):
    """The reference's restore reads the port's f32 and int32 leaves."""
    checkpoint, jnp = rck
    ref, port = _pair(jnp)
    del ref["params"]["b"], port["params"]["b"]
    ckpt.save(str(tmp_path), 7, port, blocking=True)
    got, step = checkpoint.restore(str(tmp_path), ref)
    assert step == 7 and int(got["step"]) == 7
    assert np.array_equal(np.asarray(got["params"]["w"]),
                          port["params"]["w"].numpy())


def test_reference_fault_bf16_restore(tmp_path, rck):
    """A fault of the reference: its restore cannot read back a bf16 leaf
    that its own save wrote (np.load gives '|V2', which jax refuses), so
    its --resume works only for f32 (smoke) states. The port reads the
    same files (test_port_restores_the_references)."""
    checkpoint, jnp = rck
    ref, _ = _pair(jnp)
    checkpoint.save(str(tmp_path), 7, ref, blocking=True)
    with pytest.raises(TypeError, match="V2"):
        checkpoint.restore(str(tmp_path), ref)
