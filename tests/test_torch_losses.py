"""The port's stage-1 losses (lip2speech_tpu_torch/train/losses.py) against
the JAX package's train/losses.py on the same numpy-seeded inputs. Tolerance
1e-5 relative (f32 sums of a few thousand terms in another order); the CTC
loss, computed by two different algorithms (optax.ctc_loss from logits and
paddings, F.ctc_loss from time-major log-probabilities and lengths), 1e-4."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.train import losses as jl
from lip2speech_tpu_torch.train import losses as tl

PAD = 1


def _batch(seed=0, b=3, t_frames=6, vocab=20, with_text=False, dummy_row=True):
    """Outputs and batch of a ragged stage-1 step; the last row is an
    all-masked dummy (all-pad tokens) when dummy_row."""
    rng = np.random.default_rng(seed)
    lens = np.array([t_frames, t_frames - 2, 0 if dummy_row else t_frames - 1])[:b]
    frames_mask = np.arange(t_frames)[None, :] < lens[:, None]
    tu = 2 * t_frames + 1
    tokens = rng.integers(4, vocab, (b, tu))
    pos = np.arange(tu)[None, :]
    tokens = np.where(pos < 2 * lens[:, None], tokens, PAD)
    tokens = np.where((pos == 2 * lens[:, None]) & (lens[:, None] > 0), 2, tokens)
    outputs = {"unit_logits": rng.standard_normal((b, 2 * t_frames, vocab)).astype(np.float32),
               "mel": rng.standard_normal((b, 4 * t_frames, 80)).astype(np.float32),
               "mask": np.repeat(frames_mask, 2, axis=1)}
    batch = {"unit_tokens": tokens, "frames_mask": frames_mask,
             "mel": rng.standard_normal((b, 4 * t_frames + 3, 80)).astype(np.float32)}
    if with_text:
        outputs["text_logits"] = rng.standard_normal((b, 2 * t_frames, 11)).astype(np.float32)
        text_lens = np.array([4, 3, 2])[:b]
        labels = rng.integers(1, 11, (b, 5))
        batch["text_labels"] = np.where(np.arange(5)[None, :] < text_lens[:, None], labels, 0)
        batch["text_lengths"] = text_lens
    return outputs, batch


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _close(got, ref, rtol=1e-5):
    np.testing.assert_allclose(float(got), float(ref), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("sentence_avg", [True, False])
def test_label_smoothed_ce(sentence_avg):
    outputs, batch = _batch()
    ref = jl.label_smoothed_ce(jnp.asarray(outputs["unit_logits"]),
                               jnp.asarray(batch["unit_tokens"]), PAD, 0.1, sentence_avg)
    got = tl.label_smoothed_ce(torch.from_numpy(outputs["unit_logits"]),
                               torch.from_numpy(batch["unit_tokens"]), PAD, 0.1, sentence_avg)
    for g, r in zip(got, ref):
        _close(g, r)
    assert int(got[2]) == (2 if sentence_avg else 21)       # the dummy row counts nothing


def test_unit_accuracy():
    outputs, batch = _batch(seed=1)
    logits = outputs["unit_logits"]
    tokens = batch["unit_tokens"]
    logits[0, :5, :] = -5.0
    logits[0, np.arange(5), tokens[0, :5]] = 5.0             # five sure hits
    ref = jl.unit_accuracy(jnp.asarray(logits), jnp.asarray(tokens), PAD)
    got = tl.unit_accuracy(torch.from_numpy(logits), torch.from_numpy(tokens), PAD)
    assert (int(got[0]), int(got[1])) == (int(ref[0]), int(ref[1]))
    assert int(got[0]) >= 5


@pytest.mark.parametrize("sentence_avg", [True, False])
def test_mel_loss(sentence_avg):
    outputs, batch = _batch(seed=2)
    mel_mask = np.repeat(batch["frames_mask"], 4, axis=1)
    ref = jl.mel_loss(jnp.asarray(outputs["mel"]), jnp.asarray(batch["mel"]),
                      jnp.asarray(mel_mask), sentence_avg)
    got = tl.mel_loss(torch.from_numpy(outputs["mel"]), torch.from_numpy(batch["mel"]),
                      torch.from_numpy(mel_mask), sentence_avg)
    _close(got, ref)


def test_ctc_text_loss():
    outputs, batch = _batch(seed=3, with_text=True, dummy_row=False)
    ref = jl.ctc_text_loss(jnp.asarray(outputs["text_logits"]), jnp.asarray(outputs["mask"]),
                           jnp.asarray(batch["text_labels"]), jnp.asarray(batch["text_lengths"]))
    got = tl.ctc_text_loss(torch.from_numpy(outputs["text_logits"]),
                           torch.from_numpy(outputs["mask"]),
                           torch.from_numpy(batch["text_labels"]),
                           torch.from_numpy(batch["text_lengths"]))
    assert float(ref) > 1.0
    _close(got, ref, rtol=1e-4)


@pytest.mark.parametrize("with_text", [False, True])
def test_stage1_loss(with_text):
    outputs, batch = _batch(seed=4, with_text=with_text, dummy_row=not with_text)
    ref_loss, ref_ss, ref_logs = jl.stage1_loss(_j(outputs), _j(batch), PAD, 0.1, 10.0, 1.0, True)
    got_loss, got_ss, got_logs = tl.stage1_loss(_t(outputs), _t(batch), PAD, 0.1, 10.0, 1.0, True)
    _close(got_loss, ref_loss, rtol=1e-4 if with_text else 1e-5)
    assert int(got_ss) == int(ref_ss)
    assert set(got_logs) == set(ref_logs)
    assert ("ctc_loss" in got_logs) == with_text
    for k in ref_logs:
        _close(got_logs[k], ref_logs[k], rtol=1e-4 if with_text else 1e-5)


def test_stage1_loss_gradients_match_jax():
    """d loss / d (unit_logits, mel) by both autodiffs."""
    outputs, batch = _batch(seed=5, dummy_row=False)   # see the fully-masked-row test below
    jb = _j(batch)

    def jloss(logits, mel):
        return jl.stage1_loss({"unit_logits": logits, "mel": mel, "mask": None}, jb, PAD)[0]

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(outputs["unit_logits"]),
                                          jnp.asarray(outputs["mel"]))
    logits = torch.from_numpy(outputs["unit_logits"]).requires_grad_()
    mel = torch.from_numpy(outputs["mel"]).requires_grad_()
    loss, _, _ = tl.stage1_loss({"unit_logits": logits, "mel": mel}, _t(batch), PAD)
    loss.backward()
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(ref[0]), atol=1e-6)
    np.testing.assert_allclose(mel.grad.numpy(), np.asarray(ref[1]), atol=1e-6)


def test_mel_loss_gradient_on_a_fully_masked_row():
    """A divergence on purpose: on a row with no valid frame (a dummy row of
    pad_batch_rows) the JAX mel loss takes sqrt at 0 and its gradient is not
    finite; the port gives that row value 0 and gradient 0, and the same
    value and gradient as JAX everywhere else."""
    rng = np.random.default_rng(6)
    pred, target = (rng.standard_normal((2, 8, 80)).astype(np.float32) for _ in range(2))
    mask = np.array([[True] * 8, [False] * 8])
    jgrad = jax.grad(lambda p: jl.mel_loss(p, jnp.asarray(target), jnp.asarray(mask)))(
        jnp.asarray(pred))
    assert not np.isfinite(np.asarray(jgrad)[1]).all()
    tp = torch.from_numpy(pred).requires_grad_()
    loss = tl.mel_loss(tp, torch.from_numpy(target), torch.from_numpy(mask))
    loss.backward()
    _close(loss, jl.mel_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask)))
    assert torch.isfinite(tp.grad).all() and float(tp.grad[1].abs().max()) == 0.0
    np.testing.assert_allclose(tp.grad[0].numpy(), np.asarray(jgrad)[0], atol=1e-6)
