"""The port's training driver (``repro_torch.launch.train``) on the CPU:

  * every arch's smoke config trains 3 steps with AdamW and TreeNewton;
  * the restart contract, bitwise: N steps equal k steps, a save, a
    resume and N - k more steps (params, optimizer state and step), and a
    restored checkpoint equals the state it saved;
  * a checkpoint of either package's driver resumes in the other
    (gemma-2b smoke, f32): after the resumed steps the parameters are
    within 1e-5 absolute of the other package's uninterrupted run
    (measured: 5.4e-8; f32 sums in other orders through two AdamW steps,
    where one step moves an entry by about lr = 3e-3, so a wrong leaf
    misses by 300 times the bound) and the AdamW moments within 2e-4 of
    each leaf's largest entry (tests/test_torch_train.py's bound);
  * SIGTERM to a driver process leaves a checkpoint of the step it
    stopped at, and --resume continues from it;
  * a sharded mesh and a CUDA run without a card raise.
"""
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import configs, convert
from repro_torch.launch import train as T

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--batch", "4", "--seq", "32"]


def _run(tmp, *args):
    return T.main(["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp),
                   *SMALL, *args])


def _flat(state):
    """``{name: tensor or int}`` of a train state in the reference's
    layout, stacks built."""
    out = {}
    for name, leaf in ckpt.leaves(convert.train_state_layout(state)):
        out[name] = (torch.stack(leaf.parts)
                     if isinstance(leaf, ckpt.Stacked) else leaf)
    return out


def _assert_bitwise(got, want):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for name, x in w.items():
        if isinstance(x, int):
            assert g[name] == x, name
        else:
            assert g[name].dtype == x.dtype and torch.equal(g[name], x), name


@pytest.mark.parametrize("optimizer", ["adamw", "tree_newton"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_every_arch_trains(tmp_path, arch, optimizer):
    """3 steps of each arch's smoke config: finite losses, the step count
    and the optimizer's count advanced."""
    out = _run(tmp_path, "--arch", arch, "--steps", "3", "--optimizer",
               optimizer)
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    opt = out["state"]["opt"]
    assert out["state"]["step"] == opt["count"] == 3


@pytest.mark.parametrize("arch,optimizer", [
    ("gemma-2b", "adamw"), ("gemma-2b", "tree_newton"),
    ("deepseek-v2-lite-16b", "tree_newton"), ("zamba2-2.7b", "adamw")])
def test_restart_contract_bitwise(tmp_path, arch, optimizer):
    """6 uninterrupted steps (saves at 3 and 6) against 3 steps, the save,
    a resume and 3 more: the whole state bitwise. The step-6 checkpoint
    restores bitwise the state it saved."""
    a, b = tmp_path / "a", tmp_path / "b"
    args = ["--arch", arch, "--optimizer", optimizer, "--steps", "6"]
    full = _run(a, *args, "--ckpt-every", "3")
    assert sorted(os.listdir(a)) == ["step_00000003", "step_00000006"]
    shutil.copytree(a / "step_00000003", b / "step_00000003")
    resumed = _run(b, *args, "--ckpt-every", "100", "--resume")
    assert resumed["start"] == 3 and len(resumed["losses"]) == 3
    assert resumed["losses"] == full["losses"][3:]
    _assert_bitwise(resumed["state"], full["state"])
    fresh = T.main(["--smoke", "--device", "cpu", "--arch", arch,
                    "--optimizer", optimizer, "--steps", "0",
                    "--ckpt-dir", str(tmp_path / "none")])["state"]
    layout, step = ckpt.restore_into(str(a), convert.train_state_layout(
        fresh))
    assert step == 6
    _assert_bitwise(convert.train_state_from_layout(layout, fresh),
                    full["state"])


@pytest.fixture(scope="module")
def rtrain():
    pytest.importorskip("jax")
    from repro.launch import train
    return train


def _ref_main(rtrain, monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "gemma-2b",
                                      "--smoke", *SMALL, *args])
    rtrain.main()


def _close(got_dir, want_dir, step, template):
    """The port-layout states of two checkpoints: parameters within 1e-5
    absolute, moments within 2e-4 of each leaf's largest entry, the
    counts equal."""
    g, _ = ckpt.restore(str(got_dir), convert.train_state_layout(template),
                        step=step)
    w, _ = ckpt.restore(str(want_dir), convert.train_state_layout(template),
                        step=step)
    gf, wf = dict(ckpt.leaves(g)), dict(ckpt.leaves(w))
    assert set(gf) == set(wf)
    for name, x in wf.items():
        y = gf[name]
        if isinstance(x, int):
            assert y == x == step, name
            continue
        if isinstance(x, ckpt.Stacked):
            x, y = torch.stack(x.parts), torch.stack(y.parts)
        err = float((y.double() - x.double()).abs().max())
        if name.startswith("params"):
            assert err <= 1e-5, (name, err)
        else:
            assert err <= 2e-4 * float(x.abs().max()), (name, err)


def test_cross_package_resume(tmp_path, rtrain, monkeypatch):
    """Each package's driver writes 4 steps (saves at 2 and 4); the other
    resumes its step-2 checkpoint to step 4 and saves: the two step-4
    states agree (module docstring)."""
    common = ["--steps", "4"]
    template = T.main(["--smoke", "--device", "cpu", "--steps", "0",
                       "--ckpt-dir", str(tmp_path / "none")])["state"]
    # reference -> port
    _ref_main(rtrain, monkeypatch, *common, "--ckpt-every", "2",
              "--ckpt-dir", str(tmp_path / "r"))
    shutil.copytree(tmp_path / "r" / "step_00000002",
                    tmp_path / "rp" / "step_00000002")
    out = _run(tmp_path / "rp", "--arch", "gemma-2b", *common,
               "--ckpt-every", "2", "--resume")
    assert out["start"] == 2
    _close(tmp_path / "rp", tmp_path / "r", 4, template)
    # port -> reference
    _run(tmp_path / "p", "--arch", "gemma-2b", *common, "--ckpt-every", "2")
    shutil.copytree(tmp_path / "p" / "step_00000002",
                    tmp_path / "pr" / "step_00000002")
    _ref_main(rtrain, monkeypatch, *common, "--ckpt-every", "2", "--resume",
              "--ckpt-dir", str(tmp_path / "pr"))
    _close(tmp_path / "pr", tmp_path / "p", 4, template)


def test_sigterm_saves_and_resumes(tmp_path):
    """SIGTERM to a driver process: it saves the step it stopped at
    (blocking) and exits 0; --resume continues from that step."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "100000", "--ckpt-every", "100000",
         "--ckpt-dir", str(tmp_path), *SMALL],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    lines = []
    try:
        for line in proc.stdout:            # the hook is set by step 10
            lines.append(line)
            if line.startswith("step"):
                break
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, "".join(lines) + rest
    assert "[preempt] SIGTERM" in rest
    saved = ckpt.latest_step(str(tmp_path))
    assert saved is not None and saved >= 10
    out = _run(tmp_path, "--steps", str(saved + 2), "--resume")
    assert out["start"] == saved and out["state"]["step"] == saved + 2


@pytest.mark.parametrize("mesh", ["host(2x2)", "16x16"])
def test_sharded_mesh_raises(tmp_path, mesh):
    with pytest.raises(NotImplementedError, match="A3"):
        _run(tmp_path, "--mesh", mesh, "--steps", "1")


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """--device cuda never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])
