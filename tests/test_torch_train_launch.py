"""The port's training entry point on the CPU: the three cases of the
reference's tests/test_train_e2e.py run through ``repro_torch.launch.train``
(``--device cpu``) — the loss falls by more than 0.3 over 30 steps, a run
resumes at step 5 (and from there reproduces an uninterrupted run's
losses bit for bit), accumulation 1 and 4 agree at lr 0 to rtol 1e-5 —
falcon-mamba-7b training on the CPU, and the entry point's refusals.
"""
import json
import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.launch import train as T
from repro_torch.models.transformer import tree_leaves

CPU = ["--device", "cpu"]


def test_train_loss_decreases(tmp_path):
    hist = T.main(CPU + [
        "--arch", "granite-20b", "--reduced", "--steps", "30",
        "--batch", "8", "--seq", "64", "--lr", "3e-3", "--warmup", "5",
        "--log-every", "50", "--metrics-out", str(tmp_path / "m.json")])
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert np.isfinite(last)
    assert last < first - 0.3, (first, last)
    with open(tmp_path / "m.json") as f:
        assert json.load(f) == hist
    assert [h["step"] for h in hist] == list(range(30))


def test_train_resume_is_seamless_and_exact(tmp_path):
    common = CPU + ["--arch", "llama3-8b", "--reduced", "--batch", "4",
                    "--seq", "32", "--save-every", "5"]
    # the reference's case: a 5-step run, then resumed at step 5 up to 8
    T.main(common + ["--ckpt-dir", str(tmp_path / "a"), "--steps", "5"])
    hist2 = T.main(common + ["--ckpt-dir", str(tmp_path / "a"),
                             "--steps", "8"])
    assert hist2[0]["step"] == 5
    assert len(hist2) == 3
    # resuming an 8-step run from its step-5 checkpoint gives its losses
    whole = T.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                             "--steps", "8"])
    shutil.rmtree(tmp_path / "b" / "step_8")
    resumed = T.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                               "--steps", "8"])
    assert [h["step"] for h in resumed] == [5, 6, 7]
    assert [h["loss"] for h in resumed] == [h["loss"] for h in whole[5:]]


def test_train_with_accumulation_matches_plain():
    args = CPU + ["--arch", "minitron-4b", "--reduced", "--steps", "3",
                  "--batch", "8", "--seq", "32", "--lr", "0"]
    h1 = T.main(args + ["--accum", "1"])
    h2 = T.main(args + ["--accum", "4"])
    # with lr=0 params never change; losses must agree per step
    for a, b in zip(h1, h2):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)


def test_train_falcon_mamba_on_the_cpu():
    """``--arch falcon-mamba-7b --reduced --device cpu`` trains: the
    mamba stack through B9's backward (the plain one on the CPU), the loss
    finite and falling."""
    hist = T.main(CPU + ["--arch", "falcon-mamba-7b", "--reduced",
                         "--steps", "6", "--batch", "4", "--seq", "16",
                         "--accum", "2", "--lr", "1e-2", "--warmup", "1",
                         "--log-every", "5"])
    losses = [h["loss"] for h in hist]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_entry_point_refusals(monkeypatch):
    with pytest.raises(NotImplementedError, match="A2"):
        T.main(CPU + ["--arch", "llama3-8b", "--reduced", "--steps", "1",
                      "--mesh", "2x4"])
    with pytest.raises(SystemExit):
        T.main(CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--arch", "llama3-8b", "--reduced", "--steps", "1"])


@pytest.mark.parametrize("retries,calls", [(0, 1), (1, 2)])
def test_train_step_retries(monkeypatch, retries, calls):
    """``retries`` bounds the retries of a failed gradient half; 0 retries
    none, and ``main`` retries once, as the reference does."""
    seen = []

    def failing(self, *args):
        seen.append(1)
        raise RuntimeError("step failed")

    monkeypatch.setattr(T.Model, "loss", failing)
    argv = CPU + ["--arch", "llama3-8b", "--reduced", "--steps", "2",
                  "--seq", "16"]
    with pytest.raises(RuntimeError, match="step failed"):
        if retries == 1:
            T.main(argv)
        else:
            T.main(argv, retries=retries)
    assert len(seen) == calls


def test_train_step_retries_the_gradients_and_updates_once(monkeypatch):
    """A transient failure in the backward is retried and the update is
    applied once: the step equals an unfailed one bit for bit.  A failure
    inside ``AdamW.apply``, which writes leaves in place, is not retried."""
    cfg = get_config("llama3-8b", reduced=True)
    args = T.parse_args(CPU + ["--batch", "4", "--seq", "16", "--lr",
                               "1e-2", "--warmup", "1"])
    clean = T.setup(cfg, args, retries=1)
    clean.step()
    tr = T.setup(cfg, args, retries=1)
    loss, calls = T.Model.loss, []

    def flaky(self, *a):
        calls.append(1)
        out = loss(self, *a)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return out

    monkeypatch.setattr(T.Model, "loss", flaky)
    tr.step()
    assert len(calls) == 2
    for a, b in zip(tree_leaves(tr.params), tree_leaves(clean.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(tr.opt_state), tree_leaves(clean.opt_state)):
        assert torch.equal(a, b)

    applied = []

    def failing_apply(self, *a):
        applied.append(1)
        raise RuntimeError("update failed")

    monkeypatch.setattr(T.AdamW, "apply", failing_apply)
    with pytest.raises(RuntimeError, match="update failed"):
        tr.step()
    assert applied == [1]
