"""The port's RetrievalTrainer against the reference's, and its loop.

trove-base cut to 2 x 64 in float32 on a synthetic dataset, both
trainers from the same initial parameters (the reference's, carried
across by ``params_from_jax``) and the reference's batch stream
(``default_rng(seed)`` draws through ``BinaryDataset`` of each package):
the first 3 steps' loss and grad_norm within rtol 1e-4 (float32 through
two layers, AdamW in between; the frameworks round differently in the
last bits, and the difference grows step by step).  Then the loop on the
CPU: gradient accumulation against one batch of the same samples, an
injected failure resumed to the uninterrupted run's parameters bitwise,
a SIGTERM checkpointing at the step boundary, int8 error-feedback state,
Adafactor, dev metrics, the loss falling, and the device default.
"""

import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core.collator import RetrievalCollator as RefCollator
from repro.core.config import DataArguments as RefDataArguments
from repro.core.config import MaterializedQRelConfig as RefConfig
from repro.core.config import RetrievalTrainingArguments as RefArgs
from repro.core.datasets import BinaryDataset as RefBinaryDataset
from repro.core.metrics import IRMetrics as RefIRMetrics
from repro.data.tokenizer import HashTokenizer as RefTokenizer
from repro.models.encoder import DefaultEncoder as RefEncoder
from repro.models.retriever import BiEncoderRetriever as RefRetriever
from repro.training.trainer import RetrievalTrainer as RefTrainer
from repro_torch.configs import trove_base
from repro_torch.core.collator import RetrievalCollator
from repro_torch.core.config import (DataArguments, MaterializedQRelConfig,
                                     RetrievalTrainingArguments)
from repro_torch.core.datasets import BinaryDataset
from repro_torch.core.metrics import IRMetrics
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models.convert import params_from_jax
from repro_torch.models.encoder import DefaultEncoder
from repro_torch.models.retriever import BiEncoderRetriever
from repro_torch.training.trainer import RetrievalTrainer
from repro_torch.training.tree import flatten

torch.set_num_threads(1)

RTOL = 1e-4
DATA = dict(group_size=2, vocab_size=512, query_max_len=16,
            passage_max_len=48)
TRAIN = dict(max_steps=3, learning_rate=3e-3, warmup_steps=2,
             per_device_batch_size=4, log_every=1, checkpoint_every=100)


def _cfg(data, cls=MaterializedQRelConfig, **kw):
    d = data["dir"]
    return cls(qrel_path=f"{d}/qrels/train.tsv",
               query_path=f"{d}/queries.jsonl",
               corpus_path=f"{d}/corpus.jsonl", **kw)


def _port_trainer(data, out, params=None, **kw):
    cfg = trove_base.reduced()
    retr = BiEncoderRetriever(DefaultEncoder(cfg), "infonce", 0.05)
    ds = BinaryDataset(DataArguments(**DATA), retr.format_query,
                       retr.format_passage, _cfg(data, min_score=1),
                       _cfg(data), cache_root=os.path.join(out, "cache"))
    args = RetrievalTrainingArguments(output_dir=out, **{**TRAIN, **kw})
    tr = RetrievalTrainer(retr, args, RetrievalCollator(
        DataArguments(**DATA), HashTokenizer(512)), ds, device="cpu")
    return tr, tr.init_state(params)


def test_first_steps_match_reference(retrieval_data, tmp_path):
    jcfg = ref_get_arch("trove-base").reduced().cfg
    ref_retr = RefRetriever(RefEncoder(jcfg), "infonce", 0.05)
    ref_ds = RefBinaryDataset(
        RefDataArguments(**DATA), ref_retr.format_query,
        ref_retr.format_passage, _cfg(retrieval_data, RefConfig,
                                      min_score=1),
        _cfg(retrieval_data, RefConfig),
        cache_root=str(tmp_path / "ref" / "cache"))
    ref = RefTrainer(ref_retr, RefArgs(output_dir=str(tmp_path / "ref"),
                                       **TRAIN),
                     RefCollator(RefDataArguments(**DATA),
                                 RefTokenizer(512)), ref_ds)
    ref_state = ref.init_state()
    params = params_from_jax(jax.tree.map(np.asarray, ref_state["params"]),
                             trove_base.reduced(), device="cpu")
    ref.train(ref_state)
    port, state = _port_trainer(retrieval_data, str(tmp_path / "port"),
                                params)
    port.train(state)
    assert [r["step"] for r in port.logs] == [0, 1, 2]
    for got, want in zip(port.logs, ref.logs):
        # both dense encoders report a zero MoE aux loss
        assert got["moe_aux_loss"] == want["moe_aux_loss"] == 0.0
        assert set(got) == set(want)
        for key in ("loss", "grad_norm", "contrastive_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL,
                                       err_msg=f"step {got['step']} {key}")
        assert got["in_batch_accuracy"] == want["in_batch_accuracy"]


def test_injected_failure_resumes_bitwise(retrieval_data, tmp_path):
    kw = dict(max_steps=6, checkpoint_every=2, log_every=1,
              async_checkpoint=True)
    whole, s0 = _port_trainer(retrieval_data, str(tmp_path / "a"), **kw)
    want = whole.train(s0)
    hurt, s1 = _port_trainer(retrieval_data, str(tmp_path / "b"), **kw)
    got = hurt.train(s1, inject_failure_at=4)
    # step 4 failed once after steps 0-3; step_2 restored, 3-5 rerun
    assert [r["step"] for r in hurt.logs] == [0, 1, 2, 3, 3, 4, 5]
    assert int(got["step"]) == int(want["step"]) == 6
    for (path, a), (_, b) in zip(flatten(got), flatten(want)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), path
    assert [r["loss"] for r in hurt.logs[4:]] == [r["loss"]
                                                  for r in whole.logs[3:]]
    assert sorted(os.listdir(tmp_path / "b" / "checkpoints")) == [
        "step_00000004", "step_00000006"]
    assert os.path.exists(tmp_path / "b" / "heartbeat.json")


def test_a_second_train_resumes_from_the_latest_checkpoint(retrieval_data,
                                                           tmp_path):
    tr, state = _port_trainer(retrieval_data, str(tmp_path), max_steps=3)
    first = tr.train(state)
    tr2, fresh = _port_trainer(retrieval_data, str(tmp_path), max_steps=5)
    final = tr2.train(fresh)
    assert [r["step"] for r in tr2.logs] == [3, 4]
    assert int(final["step"]) == 5
    once, s = _port_trainer(retrieval_data, str(tmp_path / "once"),
                            max_steps=5)
    straight = once.train(s)
    for (path, a), (_, b) in zip(flatten(final["params"]),
                                 flatten(straight["params"])):
        assert torch.equal(a, b), path
    assert first is not final


def test_failure_after_a_final_save_resumes_at_its_step(retrieval_data,
                                                       tmp_path):
    """A failure whose latest checkpoint is a final save (``step_3``
    holds 3 updates, where a periodic ``step_3`` holds 4): the loop
    resumes at step 3, not 4, and ends bitwise equal to a straight
    run."""
    tr, state = _port_trainer(retrieval_data, str(tmp_path), max_steps=3)
    tr.train(state)
    tr2, fresh = _port_trainer(retrieval_data, str(tmp_path), max_steps=6)
    final = tr2.train(fresh, inject_failure_at=4)
    assert [r["step"] for r in tr2.logs] == [3, 3, 4, 5]
    once, s = _port_trainer(retrieval_data, str(tmp_path / "once"),
                            max_steps=6)
    straight = once.train(s)
    for (path, a), (_, b) in zip(flatten(final["params"]),
                                 flatten(straight["params"])):
        assert torch.equal(a, b), path


def test_sigterm_checkpoints_at_the_step_boundary(retrieval_data, tmp_path):
    tr, state = _port_trainer(retrieval_data, str(tmp_path), max_steps=5)
    step_once = tr._step

    def step_then_preempt(st, batch):
        out = step_once(st, batch)
        if int(out[0]["step"]) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr._step = step_then_preempt
    with pytest.raises(SystemExit):
        tr.train(state)
    assert os.listdir(tmp_path / "checkpoints") == ["step_00000001"]


class ToyRetriever:
    """A linear least-squares model with the retriever duck-type."""

    def init_params(self, generator, device="cpu"):
        return {"w": torch.tensor([2.0, -1.0, 0.5], device=device)}

    def forward(self, params, batch):
        pred = batch["x"] @ params["w"]
        loss = ((pred - batch["y"]) ** 2).mean()
        return loss, {"mse": loss}


class _Data:
    def __init__(self, n=64, seed=0):
        rng = np.random.default_rng(seed)
        self.x = rng.normal(size=(n, 3)).astype(np.float32)
        self.y = self.x @ np.asarray([1.0, 2.0, -0.5], np.float32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return i


class _Collator:
    def __init__(self, data):
        self.data = data

    def __call__(self, idx):
        idx = np.asarray(idx)
        return {"x": self.data.x[idx], "y": self.data.y[idx]}


def _toy(tmp_path, **kw):
    data = _Data()
    base = dict(output_dir=str(tmp_path), max_steps=20, learning_rate=0.05,
                warmup_steps=0, per_device_batch_size=8, log_every=5,
                checkpoint_every=100, weight_decay=0.0)
    base.update(kw)
    return RetrievalTrainer(ToyRetriever(),
                            RetrievalTrainingArguments(**base),
                            _Collator(data), data, device="cpu")


def test_toy_convergence(tmp_path):
    tr = _toy(tmp_path, max_steps=60, learning_rate=0.1)
    state = tr.train()
    np.testing.assert_allclose(state["params"]["w"].numpy(),
                               [1.0, 2.0, -0.5], atol=0.15)
    assert tr.logs[-1]["loss"] < tr.logs[0]["loss"] * 0.01


def test_grad_accumulation_matches_one_batch_of_the_same_samples(tmp_path):
    """accum = 2 of 4 samples and accum = 1 of 8 draw the same 8 indices
    a step; a mean loss's microbatch-gradient mean is the batch gradient
    (float32: within 1e-6)."""
    one = _toy(tmp_path / "a", max_steps=15, per_device_batch_size=8,
               log_every=1).train()
    two = _toy(tmp_path / "b", max_steps=15, per_device_batch_size=4,
               grad_accum_steps=2, log_every=1).train()
    np.testing.assert_allclose(two["params"]["w"].numpy(),
                               one["params"]["w"].numpy(), atol=1e-6)


def test_int8_state_and_adafactor(tmp_path):
    tr = _toy(tmp_path / "a", grad_compression="int8")
    state = tr.init_state()
    assert set(state) == {"step", "params", "opt", "rng", "ef"}
    assert state["ef"]["w"].dtype == torch.float32
    np.testing.assert_array_equal(state["rng"], [0, 1])
    tr.train(state)
    ada = _toy(tmp_path / "b", max_steps=60, optimizer="adafactor",
               learning_rate=0.5)
    ada.train()
    assert ada.logs[-1]["loss"] < ada.logs[0]["loss"]


def test_retrieval_loss_falls_with_dev_metrics(retrieval_data, tmp_path):
    tr, state = _port_trainer(retrieval_data, str(tmp_path), max_steps=12,
                              log_every=11, learning_rate=5e-3)
    dev = [tr.train_dataset[i] for i in range(6)]
    tr.dev_dataset, tr.compute_metrics = dev, IRMetrics()
    tr.train(state)
    first, last = tr.logs
    assert last["loss"] < first["loss"]
    assert 0.0 <= last["ndcg@10"] <= 1.0 and "mrr@10" in last
    times = tr.step_ms()
    assert len(times) == 12
    assert all(t["total"] > 0 and t["forward"] > 0 and t["backward"] > 0
               for t in times)


def test_ir_metrics_match_reference():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(5, 7)).astype(np.float32)
    labels = rng.integers(0, 3, size=(5, 7)).astype(np.float32)
    labels[:, -2:] = -1
    names = ("ndcg@10", "mrr@10", "ndcg@3")
    assert IRMetrics(names)(scores, labels) == RefIRMetrics(names)(
        scores, labels)
    with pytest.raises(ValueError):
        IRMetrics(("recall@5",))(scores, labels)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_default_device_is_the_card(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RetrievalTrainer(ToyRetriever(), RetrievalTrainingArguments(
            output_dir=str(tmp_path)))
