"""The port's recognition path (lip2speech_tpu_torch: models/transformer_decoder,
models/lm, decode/beam, decode/ctc_joint, models/avhubert_asr,
models/raven_asr, eval/asr_eval, cli/infer_asr, convert/from_jax's ASR and LM
maps, scripts/orbax_to_torch.py's asr and lm kinds) against the JAX package
on the CPU, at tiny width, with weights made by numpy from a seed and
carried across.

Tolerances: tokens exactly equal; scores and logits within 1e-4 of
max(1, |ref|) (TOL). Where a search's tokens differ, the failure shows
the teacher-forced per-step scores of both n-best lists under the port,
which locate the step where the searches went apart.

Each JAX computation runs once per test run (run_once): under
pytest-xdist the first worker to need it computes it and leaves it, with
the files it wrote, in the workers' common temporary directory behind a
file lock; the others read it. Each test case has a computation of its
own, so no worker waits for another's; the weights are numpy arrays drawn
in the port's layout from a seed (the JAX trees follow by transposing, no
flax init), so every worker makes them itself.
"""

import fcntl
import functools
import importlib.util
import json
import os
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.cli import infer_asr as jcli
from lip2speech_tpu.decode import beam as jbeam
from lip2speech_tpu.decode import ctc_joint as jctc
from lip2speech_tpu.eval.asr_eval import evaluate_asr as jevaluate_asr
from lip2speech_tpu.models import avhubert_asr as javh
from lip2speech_tpu.models import lm as jlm
from lip2speech_tpu.models import raven_asr as jraven
from lip2speech_tpu.models import transformer_decoder as jdec
from lip2speech_tpu.train.checkpoint import save_pytree
from lip2speech_tpu_torch.cli import infer_asr as tcli
from lip2speech_tpu_torch.convert import from_jax
from lip2speech_tpu_torch.data.manifest import Utterance, write_manifest
from lip2speech_tpu_torch.data.video_io import save_video_gray
from lip2speech_tpu_torch.decode import beam as tbeam
from lip2speech_tpu_torch.decode import ctc_joint as tctc
from lip2speech_tpu_torch.eval.asr_eval import evaluate_asr as tevaluate_asr
from lip2speech_tpu_torch.models import avhubert_asr as tavh
from lip2speech_tpu_torch.models import lm as tlm
from lip2speech_tpu_torch.models import raven_asr as traven
from lip2speech_tpu_torch.models import transformer_decoder as tdec
from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-4                   # of max(1, |ref|): scores, logits, CTC prefix scores
V_CHAR = 39                  # the char-level SentenceProcessor's classes
AV = dict(vocab_size=V_CHAR, encoder_dim=32, encoder_heads=2, encoder_ffn_dim=64,
          encoder_layers=2, decoder_dim=32, decoder_heads=2, decoder_ffn_dim=64,
          decoder_layers=2)
RAVEN = dict(dim=32, heads=2, ffn_dim=64, layers=2, decoder_layers=2, decoder_heads=2)
LM = dict(dim=16, heads=2, ffn_dim=32, layers=2)
CLIP_LENS = (8, 11, 12, 9)   # frames of the manifest's clips (one 48-frame bucket)


def run_once(tmp_path_factory, name: str, compute):
    """compute(shared_dir) once per test run; returns (shared_dir, result).
    Under pytest-xdist the first worker to get here computes it into the
    workers' common temporary directory, behind a file lock; the others read
    it."""
    root = tmp_path_factory.getbasetemp()
    if "PYTEST_XDIST_WORKER" in os.environ:
        root = root.parent
    shared, path = root / f"{name}_files", root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.is_file():
            shared.mkdir(exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}")
            tmp.write_bytes(pickle.dumps(compute(shared)))
            tmp.replace(path)
        return shared, pickle.loads(path.read_bytes())


def close(got, ref, what=""):
    """Within TOL of max(1, |ref|), element by element."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    bad = np.abs(got - ref) > TOL * np.maximum(1.0, np.abs(ref))
    assert not bad.any(), f"{what}: {got[bad][:5]} vs {ref[bad][:5]}"


# ------------------------------------------------------------------ weights

def _draw(name: str, shape, rng) -> np.ndarray:
    """fan-in-scaled weights, norm scales near 1, non-trivial BN statistics,
    embeddings at dim ** -0.5, layerscale gammas, small biases."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) >= 2:
        return rng.normal(0, 1 / np.sqrt(np.prod(shape[1:])), shape)
    if leaf in ("weight", "running_var"):
        return rng.uniform(0.5, 1.5, shape)
    if leaf == "running_mean":
        return rng.normal(0, 0.1, shape)
    if leaf in ("embed_tokens", "embed"):
        return rng.normal(0, shape[-1] ** -0.5, shape)
    if leaf.startswith("gamma_"):
        return rng.uniform(0.05, 0.5, shape)
    return rng.normal(0, 0.05, shape)


_JAX_PERM = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}   # port -> JAX


def _jax_tree(sd: dict) -> dict:
    """A port state_dict -> the JAX variables {"params", "batch_stats"} it
    comes from (the inverse of convert/from_jax's layout moves)."""
    tree: dict = {}
    for key, x in sd.items():
        path = key.split(".")
        if path[-1] == "weight" and x.ndim >= 2:
            x = x.transpose(_JAX_PERM[x.ndim])
        col = "batch_stats" if path[-1] in ("running_mean", "running_var") else "params"
        node = tree.setdefault(col, {})
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(x)
    return tree


def _port_models():
    return {"av": lambda: tavh.AVHubertSeq2Seq(tavh.Seq2SeqConfig(**AV)),
            "raven": lambda: traven.RavenASR(traven.RavenASR.from_num_classes(V_CHAR, **RAVEN)),
            "lm_av": lambda: tlm.TransformerLM(vocab_size=V_CHAR, **LM),
            "lm_raven": lambda: tlm.TransformerLM(vocab_size=V_CHAR + 2, **LM)}


@functools.lru_cache(maxsize=None)
def _weights(name: str):
    """(JAX variables, port model in eval mode) of the tiny model `name`,
    the same numbers in both: an ASR model's variables are {"encoder",
    "decoder"} trees, an LM's one {"params"} tree."""
    model = _port_models()[name]()
    rng = np.random.default_rng(sum(map(ord, name)))
    sd = {k: _draw(k, tuple(v.shape), rng).astype(np.float32)
          for k, v in model.state_dict().items()}
    if name.startswith("lm"):
        variables = _jax_tree(sd)
        model.load_state_dict(from_jax.lm_state_dict(variables), strict=True)
    else:
        variables = {part: _jax_tree({k.split(".", 1)[1]: v for k, v in sd.items()
                                      if k.startswith(part + ".")})
                     for part in ("encoder", "decoder")}
        model.load_state_dict(from_jax.asr_state_dict(variables), strict=True)
    return variables, model.eval()


def _jax_models():
    return (javh.AVHubertSeq2Seq(javh.Seq2SeqConfig(**AV)),
            jraven.RavenASR(jraven.RavenASR.from_num_classes(V_CHAR, **RAVEN)))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _video(seed, lens, t=None, size=24):
    rng = np.random.default_rng(seed)
    t = t or max(lens)
    video = rng.standard_normal((len(lens), t, size, size, 1)).astype(np.float32)
    return video, np.arange(t)[None, :] < np.asarray(lens)[:, None]


def _first_divergence(per_step_got, per_step_ref):
    """Where two n-best lists' teacher-forced per-step scores part."""
    diff = np.abs(per_step_got - per_step_ref) > 0
    steps = np.argmax(diff, axis=-1)
    return {"first_differing_step": steps.tolist(),
            "per_step_port_nbest": np.round(per_step_got, 4).tolist(),
            "per_step_jax_nbest": np.round(per_step_ref, 4).tolist()}


def assert_nbest(got, ref, rescore, skip_below=None):
    """got / ref: (n-best lists, scores (B, beam)). Scores within TOL;
    tokens equal, else the failure shows both lists teacher-forced by the
    port (rescore(nbest) -> per-step (B, beam, L)). With skip_below, rows
    whose JAX score is below it hold only the score check: the hybrid search
    scores a hypothesis that CTC rules out at ctc_weight x LOGZERO, where
    the order among such rows is f32 rounding at the 1e10 scale."""
    (got_nbest, got_s), (ref_nbest, ref_s) = got, ref
    close(got_s, ref_s, "n-best scores")
    keep = np.ones_like(ref_s, bool) if skip_below is None else ref_s > skip_below
    got_kept = [[h for h, k in zip(hs, ks) if k] for hs, ks in zip(got_nbest, keep)]
    ref_kept = [[h for h, k in zip(hs, ks) if k] for hs, ks in zip(ref_nbest, keep)]
    if got_kept != ref_kept:
        with torch.inference_mode():
            detail = _first_divergence(rescore(got_nbest)[0].numpy(),
                                       rescore(ref_nbest)[0].numpy())
        pytest.fail(f"n-best tokens differ: port {got_nbest} jax {ref_nbest}; {detail}")
    assert keep.any()


def jax_once(request, compute):
    """compute(shared_dir) of this test case, once per test run (run_once
    under the test's node id)."""
    key = "asr_" + "".join(c if c.isalnum() else "_" for c in request.node.name)
    return run_once(request.getfixturevalue("tmp_path_factory"), key, compute)


# ---------------------------------------------------- decoder and LM logits

def _logit_inputs():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, V_CHAR, (3, 7)).astype(np.int32)
    enc = rng.standard_normal((3, 5, 32)).astype(np.float32)
    enc_mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0], [0, 0, 0, 0, 0]], bool)
    return tokens, enc, enc_mask


def _decoder_params(share_embed: bool) -> dict:
    params = dict(_weights("av")[0]["decoder"]["params"])
    if not share_embed:
        params["output_proj"] = np.random.default_rng(2).normal(0, 0.2, (32, V_CHAR)).astype(
            np.float32)
    return params


@pytest.mark.parametrize("share_embed", [True, False])
def test_decoder_logits_match_jax(request, share_embed):
    """TransformerDecoder over a batch whose third row has every encoder
    frame masked (the -1e9 fill gives a uniform average there, as in JAX);
    the untied output projection carried as output_proj. TOL."""
    tokens, enc, enc_mask = _logit_inputs()
    params = _decoder_params(share_embed)

    def compute(shared):
        dec = jdec.TransformerDecoder(vocab_size=V_CHAR, dim=32, heads=2, ffn_dim=64, layers=2,
                                      share_embed=share_embed)
        return np.asarray(dec.apply({"params": params}, tokens, enc, enc_mask))

    ref = jax_once(request, compute)[1]
    dec = tdec.TransformerDecoder(vocab_size=V_CHAR, dim=32, heads=2, ffn_dim=64, layers=2,
                                  share_embed=share_embed)
    dec.load_state_dict(from_jax.jax_tree_to_state_dict(params), strict=True)
    with torch.inference_mode():
        got = dec(torch.from_numpy(tokens).long(), torch.from_numpy(enc),
                  torch.from_numpy(enc_mask))
    close(got.numpy(), ref, "decoder logits")


def test_lm_logits_match_jax(request):
    tokens = _logit_inputs()[0]
    variables, lm = _weights("lm_av")
    ref = jax_once(request, lambda shared: np.asarray(
        jlm.TransformerLM(vocab_size=V_CHAR, **LM).apply(variables, tokens)))[1]
    with torch.inference_mode():
        got = lm(torch.from_numpy(tokens).long())
    close(got.numpy(), ref, "LM logits")


def test_sinusoidal_positions_match_jax():
    """fairseq's table at padding_idx 1, an odd width padded with zeros."""
    np.testing.assert_array_equal(tdec.sinusoidal_positions(40, 33, padding_idx=1),
                                  jdec.sinusoidal_positions(40, 33, padding_idx=1))


# ---------------------------------------------------------------- beam search

BEAM_CASES = {"ngram2_prefix_lp0.7": dict(no_repeat_ngram_size=2, prefix=True, len_penalty=0.7),
              "ngram3_lp1.3": dict(no_repeat_ngram_size=3, prefix=False, len_penalty=1.3)}
BEAM, MAX_LEN = 4, 8
PREFIX = np.array([[7, 7], [12, 4]], np.int32)


def _beam_enc():
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, 5, 32)).astype(np.float32)
    return enc, np.arange(5)[None, :] < np.asarray([5, 3])[:, None]


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_search_matches_jax(request, case):
    """beam_search over the tiny decoder (batch 2, beam 4, 8 steps) with
    repeat-n-gram blocking, length penalty and, in one case, a forced
    2-token prefix (while it is forced three of four beams are dead, all
    their candidates tie at NEG and the lower index goes first): the raw token
    rows exactly, scores within TOL; the teacher-forced rescore of the
    port's n-best gives the search's scores."""
    c = BEAM_CASES[case]
    enc, mask = _beam_enc()
    variables, model = _weights("av")

    def compute(shared):
        dec = jdec.TransformerDecoder(vocab_size=V_CHAR, dim=32, heads=2, ffn_dim=64, layers=2)
        dec_vars = _jnp({"params": variables["decoder"]["params"]})
        enc_rep, mask_rep = jnp.repeat(enc, BEAM, axis=0), jnp.repeat(mask, BEAM, axis=0)
        tokens, scores = jbeam.beam_search(
            lambda tokens, step: dec.apply(dec_vars, tokens, enc_rep, mask_rep)[:, step],
            2, BEAM, MAX_LEN, len_penalty=c["len_penalty"],
            no_repeat_ngram_size=c["no_repeat_ngram_size"],
            prefix_tokens=jnp.asarray(PREFIX) if c["prefix"] else None)
        return np.asarray(tokens), np.asarray(scores)

    ref_tokens, ref_scores = jax_once(request, compute)[1]
    dec = model.decoder
    enc_rep = torch.from_numpy(enc).repeat_interleave(BEAM, 0)
    mask_rep = torch.from_numpy(mask).repeat_interleave(BEAM, 0)
    fn = lambda tokens: dec(tokens, enc_rep, mask_rep)  # noqa: E731
    prefix = torch.from_numpy(PREFIX) if c["prefix"] else None
    kw = dict(len_penalty=c["len_penalty"], no_repeat_ngram_size=c["no_repeat_ngram_size"])
    forced = None if prefix is None else prefix.long().repeat_interleave(BEAM, 0)
    with torch.inference_mode():
        tokens, scores = tbeam.beam_search(tbeam.at_step(fn), 2, BEAM, MAX_LEN,
                                           prefix_tokens=prefix, **kw)
        per_step, final = tbeam.rescore(fn, tokens.reshape(2 * BEAM, -1), MAX_LEN,
                                        forced=forced, **kw)
    close(scores.numpy(), ref_scores, "scores")
    if not np.array_equal(tokens.numpy(), ref_tokens):
        with torch.inference_mode():
            ref_steps = tbeam.rescore(fn, torch.from_numpy(ref_tokens).long().reshape(
                2 * BEAM, -1), MAX_LEN, forced=forced, **kw)[0]
        pytest.fail(f"tokens differ: {tokens.numpy()} vs {ref_tokens}; "
                    f"{_first_divergence(per_step.numpy(), ref_steps.numpy())}")
    alive = ref_scores.reshape(-1) > jbeam.NEG / 2
    close(final.numpy()[alive], ref_scores.reshape(-1)[alive], "rescored")
    if c["prefix"]:
        assert (tokens[:, :, 1:3] == torch.from_numpy(PREFIX)[:, None, :]).all()


# ---------------------------------------------------------- AV-HuBERT seq2seq

AV_LENS = (6, 4)
AV_CASES = {"no_lm": dict(len_penalty=1.0, no_repeat_ngram_size=0, lm_weight=0.0),
            "lm": dict(len_penalty=0.8, no_repeat_ngram_size=2, lm_weight=0.5)}


def test_avhubert_encoder_matches_jax(request):
    video, mask = _video(4, AV_LENS)
    variables, model = _weights("av")
    ref = jax_once(request, lambda shared: np.asarray(
        _jax_models()[0].encode(_jnp(variables), video, mask)))[1]
    with torch.inference_mode():
        got = model.encode(torch.from_numpy(video), torch.from_numpy(mask))
    close(got.numpy(), ref, "encoder states")


@pytest.mark.parametrize("case", list(AV_CASES))
def test_avhubert_decode_beam_matches_jax(request, case):
    """AVHubertSeq2Seq.decode_beam (batch 2 ragged, beam 4, 8 steps), alone
    and with a 2-layer LM fused at 0.5 plus 2-gram blocking: the n-best
    tokens exactly, scores within TOL, and the port's rescore of its own
    n-best equal to its search's scores."""
    c = AV_CASES[case]
    video, mask = _video(4, AV_LENS)
    variables, model = _weights("av")
    lm_vars, lm = _weights("lm_av") if c["lm_weight"] else (None, None)
    opts = dict(max_len=MAX_LEN, len_penalty=c["len_penalty"],
                no_repeat_ngram_size=c["no_repeat_ngram_size"])

    def compute(shared):
        lm_kw = ({"lm": jlm.TransformerLM(vocab_size=V_CHAR, **LM),
                  "lm_variables": _jnp(lm_vars), "lm_weight": c["lm_weight"]}
                 if lm is not None else {})
        return _jax_models()[0].decode_beam(_jnp(variables), video, mask, beam=BEAM, **opts,
                                            **lm_kw)

    ref = jax_once(request, compute)[1]
    video, mask = torch.from_numpy(video), torch.from_numpy(mask)
    kw = dict(opts, lm=lm, lm_weight=c["lm_weight"])
    with torch.inference_mode():
        got = model.decode_beam(video, mask, beam=BEAM, **kw)
        _, final = model.rescore(video, mask, got[0], **kw)
    assert_nbest(got, ref, lambda nb: model.rescore(video, mask, nb, **kw))
    close(final.numpy(), got[1], "rescore of the port's n-best")


def test_avhubert_seq2seq_requires_equal_widths():
    with pytest.raises(ValueError, match="decoder_dim must equal encoder_dim"):
        tavh.AVHubertSeq2Seq(tavh.Seq2SeqConfig(**{**AV, "decoder_dim": 16}))


# --------------------------------------------------------------- CTC scoring

def _ctc_inputs():
    rng = np.random.default_rng(5)
    n, t, v, k = 3, 9, 11, 5
    logp = np.log(rng.dirichlet(np.ones(v), (n, t))).astype(np.float32)
    lens = np.array([9, 6, 3])
    r_prev = rng.normal(-6, 2, (n, t, 2)).astype(np.float32)
    last = np.array([1, 2, 3])
    cand = rng.integers(0, v, (n, k))
    cand[0, 0], cand[1, 1], cand[2, 2], cand[0, 3] = 1, 10, 0, 2     # a repeat, eos, blank
    return logp, lens, r_prev, last, cand


def test_ctc_masking_and_initial_state_match_jax(request):
    logp, lens, *_ = _ctc_inputs()

    def compute(shared):
        masked = jctc.mask_ctc_logprobs(jnp.asarray(logp), jnp.asarray(lens))
        return np.asarray(masked), np.asarray(jctc.ctc_initial_state(masked))

    ref_masked, ref_r0 = jax_once(request, compute)[1]
    masked = tctc.mask_ctc_logprobs(torch.from_numpy(logp), torch.from_numpy(lens))
    np.testing.assert_array_equal(masked.numpy(), ref_masked)
    close(tctc.ctc_initial_state(masked).numpy(), ref_r0, "r0")


@pytest.mark.parametrize("out_len", [0, 3])
@pytest.mark.parametrize("parallel_time", [False, True])
def test_ctc_extend_scores_match_jax(request, out_len, parallel_time):
    """The port's sequential recursion against the JAX scan and its
    associative-scan schedule (parallel_time): psi and the forward variables
    within TOL, with a repeated label, eos and blank among the candidates
    and ragged lengths."""
    logp, lens, r_prev, last, cand = _ctc_inputs()

    def compute(shared):
        masked = jctc.mask_ctc_logprobs(jnp.asarray(logp), jnp.asarray(lens))
        psi, r_new = jctc.ctc_extend_scores(masked, jnp.asarray(r_prev), jnp.asarray(last),
                                            out_len, jnp.asarray(cand), 0, 10, parallel_time)
        return np.asarray(psi), np.asarray(r_new)

    ref_psi, ref_r = jax_once(request, compute)[1]
    masked = tctc.mask_ctc_logprobs(torch.from_numpy(logp), torch.from_numpy(lens))
    psi, r_new = tctc.ctc_extend_scores(masked, torch.from_numpy(r_prev), torch.from_numpy(last),
                                        out_len, torch.from_numpy(cand), 0, 10)
    close(psi.numpy(), ref_psi, "psi")
    close(r_new.numpy(), ref_r, "r_new")


# -------------------------------------------------------------------- RAVEn

RAVEN_CASES = {"ample_frames": dict(lens=(12, 11), lm_weight=0.0),
               "lm": dict(lens=(12, 11), lm_weight=0.4),
               "short_row": dict(lens=(12, 5), lm_weight=0.0)}
RAVEN_MAX_LEN, RAVEN_CTC = 6, 0.3


@pytest.mark.parametrize("case", list(RAVEN_CASES))
def test_raven_decode_joint_matches_jax(request, case):
    """RavenASR.decode_joint (batch 2, beam 3, 6 steps, CTC weight 0.3), alone
    and with a 2-layer LM at 0.4: n-best tokens exactly, scores within TOL,
    and the port's rescore of its n-best equal to its search's scores. With
    ample frames (12 and 11 for at most 6 labels) every hypothesis is one
    CTC allows. In short_row the second row has 5 frames, and some of its
    hypotheses CTC rules out: they score at 0.3 x LOGZERO, and their order
    among themselves is not compared."""
    c = RAVEN_CASES[case]
    video, mask = _video(6, c["lens"])
    variables, model = _weights("raven")
    lm_vars, lm = _weights("lm_raven") if c["lm_weight"] else (None, None)

    def compute(shared):
        lm_kw = ({"lm": jlm.TransformerLM(vocab_size=V_CHAR + 2, **LM),
                  "lm_variables": _jnp(lm_vars), "lm_weight": c["lm_weight"]}
                 if lm is not None else {})
        return _jax_models()[1].decode_joint(_jnp(variables), video, mask, beam=3,
                                             max_len=RAVEN_MAX_LEN, ctc_weight=RAVEN_CTC,
                                             parallel_time=False, **lm_kw)

    ref = jax_once(request, compute)[1]
    video, mask = torch.from_numpy(video), torch.from_numpy(mask)
    kw = dict(max_len=RAVEN_MAX_LEN, ctc_weight=RAVEN_CTC, lm=lm, lm_weight=c["lm_weight"])
    with torch.inference_mode():
        got = model.decode_joint(video, mask, beam=3, **kw)
        _, final = model.rescore_joint(video, mask, got[0], **kw)
    impossible = RAVEN_CTC * tctc.LOGZERO / 2
    assert_nbest(got, ref, lambda nb: model.rescore_joint(video, mask, nb, **kw),
                 skip_below=impossible)
    alive = got[1] > impossible
    close(final.numpy()[alive], got[1][alive], "rescore of the port's n-best")
    assert (~alive).any() if case == "short_row" else alive.all()


def test_raven_token_layout():
    model = traven.RavenASR(traven.RavenASR.from_num_classes(V_CHAR, **RAVEN))
    assert (model.cfg.vocab_size, model.cfg.bos, model.cfg.eos) == (41, 40, 40)
    assert model.to_text_ids([0, 1, 5, 39, 40]) == [0, 4, 38]


# ------------------------------------------- evaluate_asr and the infer_asr CLI

def _write_clips(root):
    """The manifest of four 96 x 96 uint8 clips, with transcripts."""
    rng = np.random.default_rng(7)
    utts, transcripts = [], {}
    for i, n in enumerate(CLIP_LENS):
        uid = f"spk{i % 2}/clip{i}"
        save_video_gray(root / "video" / f"{uid}.mp4",
                        rng.integers(0, 256, (n, 96, 96), dtype=np.uint8))
        (root / "spk_emb" / f"spk{i % 2}").mkdir(parents=True, exist_ok=True)
        np.save(root / "spk_emb" / f"{uid}.npy", np.zeros(256, np.float32))
        utts.append(Utterance(uid, root / "video" / f"{uid}.mp4", root / "audio" / f"{uid}.wav",
                              n, n * 640))
        transcripts[uid] = ["hello world", "bin blue at f two now", "place red", "set it"][i]
    write_manifest(root / "label" / "test.tsv", root, utts)
    (root / "refs.json").write_text(json.dumps(transcripts))
    return root / "label" / "test.tsv", transcripts


@pytest.mark.parametrize("kind", ["av", "raven"])
def test_evaluate_asr_matches_jax(request, tmp_path, kind):
    """evaluate_asr over the four clips (one batch): AV-HuBERT with the beam,
    RAVEn with the joint search at CTC weight 0.3; the same texts and WER."""
    variables, model = _weights(kind)
    ctc_weight = 0.3 if kind == "raven" else 0.0

    def compute(shared):
        tsv, transcripts = _write_clips(shared)
        jmodel = _jax_models()[kind == "raven"]
        return jevaluate_asr(jmodel, _jnp(variables), tsv, transcripts, beam=3, max_len=6,
                             ctc_weight=ctc_weight, batch_size=4).__dict__

    want = jax_once(request, compute)[1]
    tsv, transcripts = _write_clips(tmp_path)
    got = tevaluate_asr(model, tsv, transcripts, beam=3, max_len=6, ctc_weight=ctc_weight,
                        batch_size=4, device="cpu")
    assert got.hypotheses == want["hypotheses"]
    assert (got.n_utts, got.wer) == (want["n_utts"], want["wer"]) and got.n_utts == 4


CLI_SIZES = ["--encoder-dim", "32", "--encoder-heads", "2", "--encoder-ffn-dim", "64",
             "--encoder-layers", "2", "--decoder-heads", "2", "--decoder-ffn-dim", "64",
             "--decoder-layers", "2", "--lm-dim", "16", "--lm-heads", "2", "--lm-ffn-dim", "32",
             "--lm-layers", "2", "--beam", "3", "--max-len", "6", "--batch-size", "4"]
CLI_CASES = {"avhubert": ["--no-repeat-ngram", "2", "--len-penalty", "0.8"],
             "raven": ["--raven", "--ctc-weight", "0.3"],
             "avhubert_lm": ["--lm-weight", "0.3"]}


def _jax_lm_decode(tsv, transcripts):
    """What the JAX infer_asr writes with --lm-checkpoint and --lm-weight 0.3,
    computed by its own calls: the JAX CLI passes the restored LM variables
    to the jitted search as host arrays, which the search cannot trace."""
    from lip2speech_tpu.data.stage1 import Stage1Dataset
    from lip2speech_tpu.data.text import SentenceProcessor

    processor = SentenceProcessor()
    (batch,) = Stage1Dataset(tsv, train=False).batches(4)
    nbest, scores = _jax_models()[0].decode_beam(
        _jnp(_weights("av")[0]), jnp.asarray(batch["video"]), jnp.asarray(batch["frames_mask"]),
        beam=3, max_len=6, lm=jlm.TransformerLM(vocab_size=V_CHAR, **LM),
        lm_variables=_jnp(_weights("lm_av")[0]), lm_weight=0.3)
    return {uid: {"hypo": processor.decode([t for t in nbest[i][0] if t < V_CHAR]),
                  "score": float(scores[i, 0]), "ref": transcripts[uid]}
            for i, uid in enumerate(batch["ids"])}


@pytest.fixture(scope="module")
def orbax_to_torch():
    spec = importlib.util.spec_from_file_location("orbax_to_torch",
                                                  REPO / "scripts" / "orbax_to_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_infer_asr_cli_matches_jax(request, orbax_to_torch, tmp_path, case, capsys):
    """The JAX infer_asr on orbax variables, the port's on the same
    variables converted by scripts/orbax_to_torch.py (asr and lm kinds):
    hypo.json's texts and references equal, scores within TOL, wer.txt
    equal: AV-HuBERT with 2-gram blocking and length penalty 0.8, RAVEn with
    the joint search at CTC weight 0.3. With the LM at 0.3 (lm kind) against
    the JAX package's own decode of the same batch (_jax_lm_decode)."""
    flags = CLI_CASES[case]
    names = ["raven" if "--raven" in flags else "av"] + (["lm_av"] if "--lm-weight" in flags
                                                          else [])

    def compute(shared):
        tsv, transcripts = _write_clips(shared)
        for name in names:
            save_pytree(shared / f"orbax_{name}", _weights(name)[0])
        if "lm_av" in names:
            return {"hypo": _jax_lm_decode(tsv, transcripts)}
        out_dir = shared / "jax_out"
        jcli.main(["--tsv", str(tsv), "--transcripts", str(shared / "refs.json"),
                   "--checkpoint", str(shared / f"orbax_{names[0]}"), "--out-dir", str(out_dir),
                   *CLI_SIZES, *flags])
        return {"hypo": json.loads((out_dir / "hypo.json").read_text()),
                "wer": (out_dir / "wer.txt").read_text()}

    shared, ref = jax_once(request, compute)
    capsys.readouterr()                        # the JAX CLI's own lines
    for name in names:
        orbax_to_torch.main(["--input", str(shared / f"orbax_{name}"),
                             "--output", str(tmp_path / f"{name}.pt")])
    kinds = [json.loads(line)["kind"] for line in capsys.readouterr().out.splitlines()]
    assert kinds == ["asr"] + (["lm"] if len(names) > 1 else [])
    lm = ["--lm-checkpoint", str(tmp_path / "lm_av.pt")] if len(names) > 1 else []
    out = tcli.main(["--tsv", str(shared / "label" / "test.tsv"),
                     "--transcripts", str(shared / "refs.json"),
                     "--checkpoint", str(tmp_path / f"{names[0]}.pt"),
                     "--out-dir", str(tmp_path / "out"), "--device", "cpu",
                     *CLI_SIZES, *flags, *lm])
    got = json.loads((tmp_path / "out" / "hypo.json").read_text())
    want = ref["hypo"]
    assert got.keys() == want.keys() and len(got) == 4
    for uid in want:
        assert (got[uid]["hypo"], got[uid]["ref"]) == (want[uid]["hypo"], want[uid]["ref"]), uid
        close(got[uid]["score"], want[uid]["score"], uid)
    if "wer" in ref:
        assert (tmp_path / "out" / "wer.txt").read_text() == ref["wer"]
    assert out["hypos"] == got


def test_infer_asr_random_weights_on_the_cpu(tmp_path):
    """Without --checkpoint: random weights from seed 0, built from the
    flags (no probe batch), the same file twice."""
    tsv, _ = _write_clips(tmp_path)
    outs = [tcli.main(["--tsv", str(tsv), "--out-dir", str(tmp_path / f"out{i}"),
                       "--device", "cpu", *CLI_SIZES]) for i in range(2)]
    assert outs[0]["hypos"] == outs[1]["hypos"] and len(outs[0]["hypos"]) == 4
    assert outs[0]["wer"] is None and not (tmp_path / "out0" / "wer.txt").exists()
