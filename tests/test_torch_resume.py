"""Crash-resume of the port's trainer: the checkpoint holds the full
train state (params, optimizer moments, the compressor's EF residuals
and AE), so a run killed with SIGKILL and resumed gives the uninterrupted
run's losses bit for bit (the pattern of ``tests/test_resume.py``, on
``python -m repro_torch.launch.train --device cpu``); the loader's three
``CheckpointError`` messages; and the files of the two packages, read by
each other: f32 both ways, bf16 one way (the port reads the reference's
2-byte void entries as bf16 bits; the reference's loader cannot); and
the two trainers' own files, u and v as the reference's (dp, mp, n)
arrays, each trainer resuming from the other's through its CLI."""
import json
import os
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro_torch.checkpoint import (CheckpointError, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.launch import train

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_ARGS = ["--arch", "llama3.2-1b", "--smoke", "--batch", "4",
              "--seq", "32", "--compression", "lgc_rar",
              "--topk-backend", "fused", "--ae-backend", "pallas",
              "--warmup-steps", "2", "--ae-train-steps", "3",
              "--data-shards", "2", "--transport", "ring",
              "--log-every", "1", "--device", "cpu"]
STEPS = 10


def _train(extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    # one CPU thread: the AE decoder's convolution sums in an order that
    # depends on the threads (oneDNN), so with several the compressed
    # phase is not bitwise the same from one uninterrupted run to the next
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + TRAIN_ARGS
        + extra, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _ckpt_step(path):
    try:
        with np.load(path) as z:
            return int(z["__step__"])
    except Exception:       # not yet written
        return -1


def test_kill_and_resume_bit_identical_loss_trajectory(tmp_path):
    ref_json = str(tmp_path / "ref.json")
    proc = _train(["--steps", str(STEPS), "--metrics-out", ref_json])
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]

    # the same run with periodic checkpoints, SIGKILLed once one is there
    # (the rename is atomic, so reading it is safe)
    ckpt = str(tmp_path / "victim" / "ckpt.npz")
    victim = _train(["--steps", str(STEPS), "--checkpoint-dir",
                     str(tmp_path / "victim"), "--checkpoint-every", "3"])
    deadline = time.time() + 300
    try:
        while _ckpt_step(ckpt) < 4:
            if victim.poll() is not None:
                out, _ = victim.communicate()
                raise AssertionError(f"the run ended before it could be "
                                     f"killed:\n{out[-4000:]}")
            assert time.time() < deadline, "no periodic checkpoint"
            time.sleep(0.05)
        victim.send_signal(signal.SIGKILL)
    finally:
        victim.wait(timeout=60)
    start = _ckpt_step(ckpt)
    assert 4 <= start < STEPS, start

    res_json = str(tmp_path / "res.json")
    proc = _train(["--steps", str(STEPS), "--resume", ckpt,
                   "--metrics-out", res_json])
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-4000:]
    ref = {h["step"]: h["loss"] for h in json.load(open(ref_json))}
    res = {h["step"]: h["loss"] for h in json.load(open(res_json))}
    assert min(res) == start and max(res) == STEPS - 1
    # equal, bit for bit, step for step, through the compressed phase
    # (steps 5 on), where u, v and the AE from the file do the work
    for step, loss in sorted(res.items()):
        assert ref[step] == loss, (step, ref[step], loss)


def _tree():
    return {"params": {"w": torch.ones((2, 3))},
            "opt_state": {"m": torch.zeros((2, 3))},
            "comp_state": {"u": torch.zeros((5,))}}


def test_load_checkpoint_missing_key_names_it(tmp_path):
    path = str(tmp_path / "old.npz")
    tree = _tree()
    save_checkpoint(path, {"params": tree["params"]}, 7)
    with pytest.raises(CheckpointError) as ei:
        load_checkpoint(path, tree)
    msg = str(ei.value)
    # the first missing key in the reference's (sorted) leaf order
    assert "full-state" in msg and "'comp_state/u'" in msg and path in msg


def test_load_checkpoint_not_a_checkpoint(tmp_path):
    path = str(tmp_path / "junk.npz")
    np.savez(path, foo=np.zeros(3))
    with pytest.raises(CheckpointError, match="__step__"):
        load_checkpoint(path, _tree())


def test_load_checkpoint_shape_mismatch_names_key_and_shapes(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, _tree(), 3)
    other = _tree()
    other["comp_state"]["u"] = torch.zeros((9,))
    with pytest.raises(CheckpointError) as ei:
        load_checkpoint(path, other)
    msg = str(ei.value)
    assert "comp_state/u" in msg and "(5,)" in msg and "(9,)" in msg


def test_f32_files_cross_between_packages(tmp_path):
    """The reference reads the port's file and the port the reference's,
    with the same keys, values and step."""
    r = np.random.default_rng(3)
    arrays = {"a": r.standard_normal((4, 3)).astype(np.float32),
              "b": r.standard_normal(5).astype(np.float32),
              "c": r.standard_normal((2, 7)).astype(np.float32)}
    ours = {"params": {"layers": [{"w": torch.from_numpy(arrays["a"])},
                                  {"w": torch.from_numpy(arrays["b"])}]},
            "comp_state": {"u": torch.from_numpy(arrays["c"])}}
    theirs = {"params": {"layers": [{"w": jnp.asarray(arrays["a"])},
                                    {"w": jnp.asarray(arrays["b"])}]},
              "comp_state": {"u": jnp.asarray(arrays["c"])}}
    save_checkpoint(str(tmp_path / "port.npz"), ours, 9)
    got, step = ref_load(str(tmp_path / "port.npz"), theirs)
    assert step == 9
    np.testing.assert_array_equal(np.asarray(got["params"]["layers"][1]["w"]),
                                  arrays["b"])
    np.testing.assert_array_equal(np.asarray(got["comp_state"]["u"]),
                                  arrays["c"])
    ref_save(str(tmp_path / "ref.npz"), theirs, 11)
    got, step = load_checkpoint(str(tmp_path / "ref.npz"), ours)
    assert step == 11
    assert torch.equal(got["params"]["layers"][0]["w"],
                       torch.from_numpy(arrays["a"]))
    assert torch.equal(got["comp_state"]["u"], torch.from_numpy(arrays["c"]))


def test_bf16_files_read_as_bf16_bits(tmp_path):
    """A bf16 leaf is a 2-byte void entry in both packages' files: the
    port writes the reference's bits and reads the reference's file into
    a bf16 template, and its own, bit for bit; f32 leaves beside them
    keep their values."""
    r = np.random.default_rng(5)
    w = r.standard_normal((3, 4)).astype(np.float32)
    u = r.standard_normal(6).astype(np.float32)
    theirs = {"params": {"w": jnp.asarray(w, jnp.bfloat16)},
              "comp_state": {"u": jnp.asarray(u)}}
    ours = {"params": {"w": torch.from_numpy(w).to(torch.bfloat16)},
            "comp_state": {"u": torch.from_numpy(u)}}
    bits = np.asarray(theirs["params"]["w"]).view(np.int16)
    np.testing.assert_array_equal(ours["params"]["w"].view(torch.int16)
                                  .numpy(), bits)
    ref_save(str(tmp_path / "ref.npz"), theirs, 2)
    save_checkpoint(str(tmp_path / "port.npz"), ours, 2)
    with np.load(str(tmp_path / "ref.npz")) as z, \
            np.load(str(tmp_path / "port.npz")) as p:
        assert z["params/w"].dtype == p["params/w"].dtype == np.dtype("V2")
        assert z["params/w"].tobytes() == p["params/w"].tobytes()
    for name in ("ref.npz", "port.npz"):
        got, step = load_checkpoint(str(tmp_path / name), ours)
        assert step == 2 and got["params"]["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got["params"]["w"].view(torch.int16).numpy(), bits)
        assert torch.equal(got["comp_state"]["u"], torch.from_numpy(u))


# the trainers' files across the packages: K = 2, lgc_rar, 3 steps (one a
# phase), each trainer's file of step 2 (saved after step 1) resumed by
# the other trainer through its CLI for the compressed step 2
CROSS = ["--arch", "llama3.2-1b", "--smoke", "--batch", "4", "--seq", "32",
         "--compression", "lgc_rar", "--optimizer", "sgd_momentum",
         "--warmup-steps", "1", "--ae-train-steps", "1", "--data-shards", "2",
         "--steps", "3", "--log-every", "1"]
REF_CROSS = """
import json, os, sys, time
import repro.checkpoint as C
from repro.launch import train
flags = json.loads(sys.argv[1])
save = C.save_checkpoint
# the file of step 2 alone (the trainer saves after every step)
C.save_checkpoint = lambda path, tree, step: (
    save(path, tree, step) if step == 2 else None)
train.main(flags + ["--metrics-out", "ref.json", "--checkpoint-dir", "ref",
                    "--checkpoint-every", "1"])
open("ref.done", "w").close()
t0 = time.time()
while not os.path.exists("port.done"):
    assert time.time() - t0 < 300, "no port file"
    time.sleep(0.1)
train.main(flags + ["--resume", "port/ckpt.npz", "--metrics-out",
                    "ref_resumed.json"])
"""


def _wait_for(path, proc, log, timeout=300.0):
    t0 = time.time()
    while not os.path.exists(path):
        if proc.poll() is not None or time.time() - t0 > timeout:
            raise AssertionError(f"no {path}:\n"
                                 + open(log).read()[-3000:])
        time.sleep(0.1)


def test_trainer_files_cross_between_packages(tmp_path):
    """The emulated trainer's file holds u, v as (K, 1, n), the
    reference trainer's (dp, mp, n_local); each trainer resumes from the
    other's file of step 2, and its compressed step 2's loss is within
    1e-5 of the other's uninterrupted run."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)        # the CLI asks for its devices
    log = str(tmp_path / "ref.log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", REF_CROSS, json.dumps(CROSS)],
            cwd=str(tmp_path), env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        cfg = get_arch("llama3.2-1b").reduced()
        port = str(tmp_path / "port")

        def keep(rec):
            if rec["step"] == 1:
                os.makedirs(port)
                os.replace(str(tmp_path / "run" / "ckpt.npz"),
                           os.path.join(port, "ckpt.npz"))
                open(str(tmp_path / "port.done"), "w").close()
        whole = train.run(cfg, train.parse_args(CROSS + [
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / "run"),
            "--checkpoint-every", "1"]), on_step=keep)["history"]
        with np.load(os.path.join(port, "ckpt.npz")) as z:
            assert int(z["__step__"]) == 2
            assert z["comp_state/u"].shape == z["comp_state/v"].shape \
                == (2, 1, z["comp_state/u"].shape[-1])
        _wait_for(str(tmp_path / "ref.done"), proc, log)
        resumed = train.run(cfg, train.parse_args(CROSS + [
            "--device", "cpu", "--resume",
            str(tmp_path / "ref" / "ckpt.npz")]))
        assert resumed["resumed"]["step"] == 2
        assert proc.wait(timeout=300) == 0, open(log).read()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
    ref = json.load(open(tmp_path / "ref.json"))
    ref_resumed = json.load(open(tmp_path / "ref_resumed.json"))
    assert [h["phase"] for h in whole] == ["warmup", "topk_ae", "compressed"]
    assert [h["step"] for h in resumed["history"]] == [2]
    assert [h["step"] for h in ref_resumed] == [2]
    # the port from the reference's file; the reference from the port's
    np.testing.assert_allclose(resumed["history"][0]["loss"], ref[2]["loss"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ref_resumed[0]["loss"], whole[2]["loss"],
                               rtol=0, atol=1e-5)
