"""The port's pre-training CLI (``sarssl_torch.cli.run_pretrain``) against the
JAX package's: the same parser (flags, defaults, ``dest`` names, so the same
``config.json`` keys), the JAX learner's JSONL record keys, ``--smoke`` on
the CPU, ``--resume``, ``--init-ckpt`` from a JAX-written directory, every
unported flag raising, and no silent fall-back to the CPU.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sarssl_tpu.cli.run_pretrain import build_parser as j_build_parser  # noqa: E402
from sarssl_tpu.models import SARSSL as JSARSSL  # noqa: E402
from sarssl_tpu.models import SARSSLConfig as JSARSSLConfig  # noqa: E402
from sarssl_tpu.ops import gen_patch_mask  # noqa: E402
from sarssl_tpu.train import checkpoint as jckpt  # noqa: E402
from sarssl_tpu.train import create_train_state as j_create_state  # noqa: E402
from sarssl_torch.cli.run_pretrain import build_parser, main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the records PretrainLearner.train_epoch / eval_epoch log in both packages
# (tests/test_torch_learner.py holds the two learners' logs key for key)
TRAIN_KEYS = {"split", "step", "time", "loss", "diff", "lr", "utt_per_sec"}
VAL_KEYS = {"split", "step", "time", "loss", "diff"}


def _records(exp):
    with open(os.path.join(exp, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _smoke(exp, *more):
    return main(["--smoke", "--cpu", "--exp-dir", str(exp), *more])


def test_parser_matches_jax():
    def table(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.choices,
                         a.const) for a in parser._actions}
    assert table(build_parser()) == table(j_build_parser())
    assert vars(build_parser().parse_args([])) == vars(j_build_parser().parse_args([]))


def test_smoke_on_cpu_passes_and_writes_jax_files(tmp_path, capsys):
    assert _smoke(tmp_path) == 0
    out = capsys.readouterr().out
    assert "SMOKE PASS" in out and "TF32 off" in out
    with open(tmp_path / "config.json") as f:
        config = json.load(f)
    assert set(config) == set(vars(j_build_parser().parse_args([])))
    assert config["smoke"] and config["synthetic"] and config["bs"] == 4
    assert sorted(os.listdir(tmp_path / "checkpoints")) == [
        "best_model.msgpack", "latest_model.msgpack", "model0.msgpack", "model1.msgpack"]
    recs = _records(tmp_path)
    assert [(r["split"], r["step"]) for r in recs] == [("train", 0), ("val", 0), ("train", 1),
                                                        ("val", 1)]
    for r in recs:
        assert set(r) == (TRAIN_KEYS if r["split"] == "train" else VAL_KEYS)
    assert [r["lr"] for r in recs if r["split"] == "train"] == [1e-3, 5e-4]
    # the files are JAX's: its loader reads them, epoch and optimizer state included
    payload = jckpt.load_checkpoint(jckpt.latest_path(str(tmp_path / "checkpoints")))
    assert payload["meta"]["epoch"] == 1
    assert int(payload["opt_state"]["inner_state"]["0"]["0"]["count"]) == 8


def test_resume_continues_at_the_next_epoch(tmp_path, capsys):
    assert _smoke(tmp_path, "--epochs", "1") == 0
    capsys.readouterr()
    assert _smoke(tmp_path, "--epochs", "2", "--resume") == 0
    out = capsys.readouterr().out
    assert "resumed from epoch 0 (latest_model.msgpack)" in out
    assert "epoch 0:" not in out and "epoch 1:" in out
    assert [r["step"] for r in _records(tmp_path) if r["split"] == "train"] == [0, 1]
    payload = jckpt.load_checkpoint(jckpt.latest_path(str(tmp_path / "checkpoints")))
    assert int(payload["opt_state"]["inner_state"]["0"]["0"]["count"]) == 8  # 4 + 4 steps


def test_resume_from_best_restores_the_high_water_mark(tmp_path, capsys):
    assert _smoke(tmp_path, "--epochs", "1") == 0
    best = jckpt.load_checkpoint(jckpt.best_path(str(tmp_path / "checkpoints")))
    capsys.readouterr()
    assert _smoke(tmp_path, "--epochs", "2", "--resume-from-best") == 0
    assert "resumed from epoch 0 (best_model.msgpack)" in capsys.readouterr().out
    val = [r["loss"] for r in _records(tmp_path) if r["split"] == "val"]
    again = jckpt.load_checkpoint(jckpt.best_path(str(tmp_path / "checkpoints")))
    assert again["meta"]["epoch"] == (1 if -val[1] >= best["meta"]["max_score"] else 0)


def test_init_ckpt_reads_a_jax_directory(tmp_path, capsys):
    """A JAX state of the smoke model, saved by the JAX package, loads into
    every parameter of the port's."""
    nf, nt = 256, 8  # the smoke run's 2304 samples
    jcfg = JSARSSLConfig(dtype="float32").tiny(sig_shape=(nf, nt, 2, 2), patch_shape=(nf, 1),
                                               spec_dembed=32, spat_dembed=16)
    mask = gen_patch_mask(jax.random.key(0), 2, jcfg.npatch, jcfg.effective_nmasked())
    state = j_create_state(JSARSSL(jcfg), jax.random.key(7), jnp.zeros((2, 2, nf, nt, 2)), mask)
    src = tmp_path / "jax_run"
    jckpt.save_checkpoint(str(src), state, 5, -1.0, is_best=True)
    n = len(jax.tree.leaves(state.params))
    assert _smoke(tmp_path / "port_run", "--epochs", "1", "--init-ckpt", str(src)) == 0
    assert f"partial_load: {n}/{n} keys loaded" in capsys.readouterr().out


UNPORTED = [["--real-data-dirs", "d"], ["--real-corpora", "AMI=d"], ["--real-data-probs", "1"],
            ["--remove-spkoverlap"], ["--mesh", "1x1"]]


@pytest.mark.parametrize("flag", UNPORTED, ids=[f[0] for f in UNPORTED])
def test_unported_flags_raise(flag, tmp_path):
    with pytest.raises(NotImplementedError, match=flag[0]):
        _smoke(tmp_path, *flag)
    assert not os.listdir(tmp_path)  # raised before writing anything


def test_without_cpu_and_without_a_gpu_main_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--smoke", "--exp-dir", str(tmp_path)])


@pytest.mark.parametrize("cpu", [True, False], ids=["cpu", "no_cpu_flag"])
def test_module_entry_point(cpu, tmp_path):
    """``python -m sarssl_torch.cli.run_pretrain --smoke [--cpu]``: SMOKE PASS
    on the CPU; without ``--cpu`` it needs a card and fails without one."""
    if not cpu and torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, "-m", "sarssl_torch.cli.run_pretrain", "--smoke",
                          "--exp-dir", str(tmp_path)] + (["--cpu"] if cpu else []), cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if cpu:
        assert out.returncode == 0, out.stderr
        assert "SMOKE PASS" in out.stdout
    else:
        assert out.returncode != 0
        assert "torch.cuda.is_available() is False" in out.stderr
        assert "SMOKE" not in out.stdout
