"""``repro_torch.launch.train``, the port of ``repro.launch.train``, and
``parse_cli``.

``main --smoke --device cpu`` trains trove-base cut to 2 x 64 (float32)
on a synthetic dataset it writes, and leaves checkpoints the reference's
``restore_checkpoint`` reads.  Without a card the default device raises;
flags whose modules are not ported raise and name their ROADMAP item,
before any work.  ``parse_cli`` fills each class's fields as the
reference's does.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import config as ref_config
from repro.models import transformer as ref_tf
from repro.training import checkpoint as ref_ckpt
from repro_torch.core import config
from repro_torch.launch import train
from repro_torch.training.tree import flatten

torch.set_num_threads(1)

SMOKE = ["--smoke", "--device", "cpu", "--per_device_batch_size", "4",
         "--log_every", "1"]


def test_smoke_trains_and_writes_reference_checkpoints(tmp_path):
    out = str(tmp_path / "run")
    trainer, state = train.main(SMOKE + [
        "--data-dir", str(tmp_path / "data"), "--output_dir", out,
        "--max_steps", "5", "--checkpoint_every", "2",
        "--keep_checkpoints", "3", "--loss", "infonce", "--group_size", "3"])
    assert int(state["step"]) == 5
    assert len(trainer.logs) == 5
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in trainer.logs)
    assert trainer.train_dataset.args.group_size == 3
    ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert ckpts == ["step_00000002", "step_00000004", "step_00000005"]
    # the reference's restore, into the reference's template
    jcfg = ref_get_arch("trove-base").reduced().cfg
    template = {"step": np.zeros((), np.int32),
                "params": ref_tf.init_params(jcfg, jax.random.key(0)),
                "opt": {}, "rng": np.zeros(2, np.uint32)}
    ref = ref_ckpt.restore_checkpoint(
        ref_ckpt.latest_checkpoint(os.path.join(out, "checkpoints")),
        template)
    assert int(ref["step"]) == 5
    got = {"/".join(str(k.key) for k in p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(
               ref["params"])[0]}
    for key, leaf in flatten(state["params"]):
        np.testing.assert_array_equal(got[key], leaf.numpy(), err_msg=key)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_is_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--data-dir", str(tmp_path / "data"),
                    "--output_dir", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "data")


# a GNN or recsys arch raises a ValueError (the reference's launcher
# drives LM encoders only); the cases keep their ids
@pytest.mark.parametrize("extra,error,match", (
    pytest.param(["--arch", "graphsage-reddit"], ValueError,
                 "gnn arch.*LM encoders only", id="extra0-item 8"),
    pytest.param(["--arch", "deepfm"], ValueError,
                 "recsys arch.*LM encoders only", id="extra1-item 8"),
    # the production meshes need a process group of 256 / 512 ranks
    pytest.param(["--mesh", "pod"], ValueError, "needs 256 ranks",
                 id="extra2-item 10"),
    pytest.param(["--multi-pod"], ValueError, "needs 512 ranks",
                 id="extra3-item 10"),
))
def test_unported_flags_raise_naming_their_item(tmp_path, extra, error,
                                                match):
    with pytest.raises(error, match=match):
        train.main(SMOKE + ["--data-dir", str(tmp_path / "data"),
                            "--output_dir", str(tmp_path / "run"), *extra])
    assert not os.listdir(tmp_path)          # raised before any work


def test_parse_cli_matches_reference():
    argv = ["--learning_rate", "3e-4", "--max_steps=7", "--loss", "ws",
            "--group_size", "4", "--async_checkpoint", "false",
            "--temperature", "0.05", "--optimizer", "adafactor",
            "--unknown", "1", "--seed", "3", "--append_eos"]
    port = config.parse_cli(config.RetrievalTrainingArguments,
                            config.ModelArguments, config.DataArguments,
                            argv=argv)
    ref = ref_config.parse_cli(ref_config.RetrievalTrainingArguments,
                               ref_config.ModelArguments,
                               ref_config.DataArguments, argv=argv)
    for p, r in zip(port, ref):
        shared = {f.name for f in dataclasses.fields(p)} & {
            f.name for f in dataclasses.fields(r)}
        assert shared
        for name in shared - {"output_dir"}:
            assert getattr(p, name) == getattr(r, name), name
    train_args, model_args, data_args = port
    assert (train_args.learning_rate, train_args.max_steps) == (3e-4, 7)
    assert train_args.async_checkpoint is False
    assert (model_args.loss, data_args.group_size) == ("ws", 4)
    assert data_args.append_eos is True
    assert config.parse_cli(config.ModelArguments, argv=[]) == \
        config.ModelArguments()


def test_training_arguments_defaults_match_reference():
    port = config.RetrievalTrainingArguments()
    ref = ref_config.RetrievalTrainingArguments()
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        if f.name != "output_dir":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert config.DataArguments().group_size == \
        ref_config.DataArguments().group_size == 2
