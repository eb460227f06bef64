"""The port's serving process (pipeline/server.py, batcher.py, streaming.py)
against the JAX server, on the CPU at the tiny preset.

One JAX server and one port server, each started once for the module, serve
the same weights (two pipelines and a speaker encoder, made with numpy from
a seed on the JAX side and carried with convert/from_jax). Every request
goes to both: status codes, JSON keys and the values that do not depend on
the clock or the device must be equal, and decoded PCM16 within 1 step
(the float waveforms agree to ~1e-6; the truncation to int16 can flip one
step). Then the port's batcher (valid rows equal the unbatched call within
1e-5) and websocket endpoint (out-of-order frames give _synthesise_frames'
result exactly)."""

import asyncio
import base64
import functools
import io
import json
import socket
import threading
import wave
from http.client import HTTPConnection
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lip2speech_tpu.core import config as jcfg
from lip2speech_tpu.models.multi_target import MultiTargetModel as JaxModel
from lip2speech_tpu.models.vocoder import MelCodeGenerator as JaxGenerator
from lip2speech_tpu.pipeline import server as jserver
from lip2speech_tpu.pipeline.synthesise import Lip2SpeechPipeline as JaxPipeline
from lip2speech_tpu_torch.core import config as tcfg
from lip2speech_tpu_torch.pipeline import server as tserver
from lip2speech_tpu_torch.pipeline.batcher import DynamicBatcher
from lip2speech_tpu_torch.pipeline.landmarks import HeuristicLandmarks
from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline as TorchPipeline
from lip2speech_tpu_torch.train import checkpoint
from lip2speech_tpu_torch.utils.audio_io import write_wav

from test_heuristic_landmarks import _render_face_video
from test_torch_speaker_denoise import encoder_from, speaker_params
from torch_tmp import tmp_path  # noqa: F401  (removed when the test passes)

TIMEOUT = 120          # every HTTP call and join: a hung server fails a test
PCM_TOL = 1            # PCM16 steps
# values that must be equal on both servers (the rest depend on the clock,
# the device's name, or the output path each server was given)
COMPARED = ("num_samples", "sample_rate", "checkpoints", "active", "audios", "usage_count",
            "upload_id", "complete", "available", "status", "active_checkpoint", "message",
            "email_sent")


def _random_variables(tree, rng):
    """numpy values for an abstract flax tree: fan-in-scaled weights, norm
    scales and weight-norm gains of order 1, non-trivial BN statistics."""
    def fill(name, x):
        shape = x.shape
        if name in ("weight", "weight_v") and len(shape) >= 2:
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        if name in ("weight", "weight_g") or name == "running_var":
            return rng.uniform(0.5, 1.5, shape)
        if name == "running_mean":
            return rng.normal(0, 0.1, shape)
        return rng.normal(0, 1.0 if name == "embedding" else 0.05, shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else fill(k, v).astype(np.float32)
                for k, v in node.items()}
    return walk(tree)


@functools.lru_cache(maxsize=1)
def _shapes():
    """The tiny preset's abstract stage-1 variables and vocoder params:
    flax's eager init of the full-width ResNet3D frontend takes ~40 s on the
    CPU, its abstract shapes ~2 s."""
    cfg, k = jcfg.preset("tiny"), jax.random.PRNGKey(0)
    s1 = jax.eval_shape(lambda: JaxModel(cfg.model).init(
        {"params": k, "dropout": k}, jnp.zeros((1, 4, 88, 88, 1)), jnp.ones((1, 4), bool),
        jnp.zeros((1, 256)), train=False))
    voc = jax.eval_shape(lambda: JaxGenerator(cfg.vocoder).init(
        {"params": k}, jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 16, 80)),
        jnp.zeros((1, 256)), deterministic=True))
    return dict(s1), dict(voc)["params"]


def _weights(seed):
    """Stage-1 variables and vocoder params of the tiny preset, from numpy."""
    s1, voc = _shapes()
    rng = np.random.default_rng(seed)
    return _random_variables(s1, rng), _random_variables(voc, rng)


def _serve(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(0)
    jax_pipes, torch_pipes = {}, {}
    for name, seed in (("tiny", 1), ("tiny2", 2)):
        s1, voc = _weights(seed)
        jax_pipes[name] = JaxPipeline(jcfg.preset("tiny"), s1, voc)
        torch_pipes[name] = TorchPipeline.from_jax_variables(tcfg.preset("tiny"), s1, voc,
                                                             device="cpu")
    spk_params = speaker_params(3)
    encoder = encoder_from(spk_params)

    voices = root / "voices"
    voices.mkdir()
    np.save(voices / "alice.npy", rng.standard_normal(256).astype(np.float32))
    write_wav(voices / "bob.wav", 0.3 * rng.standard_normal(24_000), 16_000)
    static = root / "static"
    static.mkdir()
    (static / "a.wav").write_bytes(b"RIFFdata")
    (root / "secret.txt").write_bytes(b"nope")
    files = SimpleNamespace(
        clip=root / "clip.npy", clip2=root / "clip2.npy", long=root / "long.npy",
        raw=root / "raw.npy", lms=root / "lms.npy", spk_wav=root / "spk.wav",
        spk_emb=root / "spk.npy", too_long=root / "too_long.npy", mel=root / "mel.npy",
        unt=root / "u.unt", root=root)
    np.save(files.clip, rng.integers(0, 256, (30, 96, 96), dtype=np.uint8))
    np.save(files.clip2, rng.integers(0, 256, (17, 96, 96), dtype=np.uint8))
    np.save(files.long, rng.integers(0, 256, (45, 96, 96), dtype=np.uint8))
    np.save(files.too_long, np.zeros((601, 96, 96), np.uint8))
    raw = _render_face_video(4)
    np.save(files.raw, raw)
    np.save(files.lms, np.stack(HeuristicLandmarks()(raw)))
    write_wav(files.spk_wav, 0.3 * rng.standard_normal(20_000), 16_000)
    np.save(files.spk_emb, rng.standard_normal(256).astype(np.float32))
    units = rng.integers(0, 200, 40)
    np.save(files.mel, rng.standard_normal((80, 80)).astype(np.float32))
    files.unt.write_text(" ".join(map(str, units)))
    files.units = units.tolist()

    kw = dict(default_audio_dir=str(voices), static_dir=str(static))
    servers = {
        "jax": jserver.make_server(port=0, pipelines=jax_pipes, speaker_params=spk_params,
                                   inputs_dir=str(root / "in_jax"), **kw),
        "torch": tserver.make_server(port=0, pipelines=torch_pipes, speaker_encoder=encoder,
                                     inputs_dir=str(root / "in_torch"), **kw)}
    threads = [_serve(s) for s in servers.values()]
    yield SimpleNamespace(servers=servers, files=files, torch_pipes=torch_pipes, encoder=encoder)
    for s in servers.values():
        s.shutdown()
        s.server_close()
    servers["torch"].RequestHandlerClass.state.close()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()


def _request(srv, method, path, body=None, headers=None):
    conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=TIMEOUT)
    if isinstance(body, dict):
        body = json.dumps(body)
    conn.request(method, path, body, headers or {})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    ctype = resp.getheader("Content-Type", "")
    return resp.status, (json.loads(raw) if ctype == "application/json" else raw), resp


def _pcm(b64: str) -> np.ndarray:
    with wave.open(io.BytesIO(base64.b64decode(b64))) as w:
        assert (w.getframerate(), w.getsampwidth(), w.getnchannels()) == (16000, 2, 1)
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def _both(env, method, path, body=None, headers=None, body_for=None):
    """The same request to both servers (body_for(server_name) builds a body
    per server). Returns the port's answer after holding it to the JAX one."""
    out = {}
    for name, srv in env.servers.items():
        b = body_for(name) if body_for else body
        out[name] = _request(srv, method, path, b, headers)
    (jcode, jout, jresp), (tcode, tout, tresp) = out["jax"], out["torch"]
    assert tcode == jcode, (path, jout, tout)
    for h in ("Content-Type", "Location"):
        assert tresp.getheader(h) == jresp.getheader(h)
    if isinstance(jout, dict):
        assert set(tout) == set(jout), (path, jout, tout)
        for key in COMPARED:
            assert tout.get(key) == jout.get(key), (path, key, jout.get(key), tout.get(key))
        if "wav_base64" in jout:
            jpcm, tpcm = _pcm(jout["wav_base64"]), _pcm(tout["wav_base64"])
            assert tpcm.shape == jpcm.shape == (jout["num_samples"],)
            diff = np.abs(tpcm.astype(np.int32) - jpcm.astype(np.int32)).max()
            assert diff <= PCM_TOL, (path, diff)
            assert np.abs(jpcm).max() > 1000          # not silence
    else:     # the demo page names the card where the JAX one names the TPU
        assert tout == jout.replace(b"one jitted TPU program", b"one device call on the card")
    return tcode, tout


@pytest.mark.parametrize("path", [
    "/health", "/checkpoints", "/audios", "/demo", "/vsg", "/nope", "/cdn/a.wav",
    "/cdn/../secret.txt", "/cdn/%2e%2e/secret.txt", "/cdn/missing.bin", "/cdn/%00",
    "/audio/clip7", "/video/x%0d%0aSet-Cookie:%20pwned%3D1", "/audio/a/../b"])
def test_get_routes_match_jax(env, path):
    code, out = _both(env, "GET", path)
    if path == "/health":
        assert out["devices"] == ["cpu"] and out["status"] == "ok"
    if path in ("/checkpoints", "/audios"):
        assert code == 200 and out[path[1:]] == (["tiny", "tiny2"] if path == "/checkpoints"
                                                  else ["alice", "bob"])


def _multipart(boundary, parts):
    out = []
    for name, filename, payload in parts:
        disp = f'name="{name}"' + (f'; filename="{filename}"' if filename else "")
        out.append(f"--{boundary}\r\nContent-Disposition: form-data; {disp}\r\n\r\n".encode()
                   + payload + b"\r\n")
    return b"".join(out) + f"--{boundary}--\r\n".encode()


def _synthesise_cases(f):
    mp = "multipart/form-data; boundary=l2sb"
    return {
        "json": ("/synthesise", {"video_path": str(f.clip)}, None),
        "cid": ("/synthesise?cid=tiny2", {"video_path": str(f.clip2)}, None),
        "aid_npy": ("/synthesise?aid=alice", {"video_path": str(f.clip2)}, None),
        "aid_wav": ("/synthesise?aid=bob&log=0", {"video_path": str(f.clip2)}, None),
        "spk_wav": ("/synthesise", {"video_path": str(f.clip2), "spk_wav_path": str(f.spk_wav)},
                    None),
        "spk_emb": ("/synthesise", {"video_path": str(f.clip2), "spk_emb_path": str(f.spk_emb)},
                    None),
        "multipart": ("/synthesise", _multipart("l2sb", [
            ("video", "up.npy", f.clip2.read_bytes()), ("audio", "a.wav", f.spk_wav.read_bytes())]),
            {"Content-Type": mp}),
        "multipart_no_video": ("/synthesise", _multipart("l2sb", []), {"Content-Type": mp}),
        "landmarks_path": ("/synthesise", {"video_path": str(f.raw), "landmarks_path": str(f.lms)},
                           None),
        "close_up_0": ("/synthesise?close_up=0", {"video_path": str(f.raw)}, None),
        "vsg": ("/vsg/synthesise", {"video_path": str(f.long)}, None),
        "too_long": ("/synthesise", {"video_path": str(f.too_long)}, None),
        "bad_path": ("/synthesise", {"video_path": str(f.root / "nope.npy")}, None),
        "unknown_cid": ("/synthesise?cid=nope", {"video_path": str(f.clip2)}, None),
        "unknown_aid": ("/synthesise?aid=ghost", {"video_path": str(f.clip2)}, None),
        "output_path": ("/synthesise", None, None),    # a body per server
    }


@pytest.mark.parametrize("case", [
    "json", "cid", "aid_npy", "aid_wav", "spk_wav", "spk_emb", "multipart",
    "multipart_no_video", "landmarks_path", "close_up_0", "vsg", "too_long", "bad_path",
    "unknown_cid", "unknown_aid", "output_path"])
def test_synthesise_routes_match_jax(env, case, monkeypatch):
    # /vsg/synthesise cuts at 23.5 s; a 1 s cut gives the 45-frame clip two
    # segments (25 + 20 frames) at the tiny model's cost
    for mod in (jserver, tserver):
        monkeypatch.setattr(mod, "MAX_SEGMENT_S", 1.0)
    f = env.files
    path, body, headers = _synthesise_cases(f)[case]
    body_for = None
    if case == "output_path":
        body_for = lambda name: {"video_path": str(f.clip2),  # noqa: E731
                                 "output_path": str(f.root / f"out_{name}.wav")}
    code, out = _both(env, "POST", path, body, headers, body_for)
    want = {"json": 30 * 640, "landmarks_path": 4 * 640, "close_up_0": 4 * 640,
            "vsg": 45 * 640}.get(case, 17 * 640)
    if case in ("too_long", "bad_path", "unknown_cid", "unknown_aid", "multipart_no_video"):
        assert code == 400
    else:
        assert code == 200 and out["num_samples"] == want
    if case == "output_path":
        from lip2speech_tpu_torch.utils.audio_io import read_wav
        jw, tw = (read_wav(f.root / f"out_{n}.wav")[0] for n in ("jax", "torch"))
        assert np.abs(jw - tw).max() <= PCM_TOL / 32768


def test_vocode_route_matches_jax(env):
    f = env.files
    cases = [({"units": f.units, "mel_path": str(f.mel)}, 200),
             ({"unt_path": str(f.unt), "mel_path": str(f.mel), "cid": "tiny2"}, 200),
             ({"units": f.units, "mel_path": str(f.mel), "spk_emb_path": str(f.spk_emb)}, 200),
             ({"units": f.units, "mel_path": str(f.root / "nope.npy")}, 400),
             ({"units": f.units[:4], "mel_path": str(f.mel)}, 400),
             ({"units": [[u] for u in f.units], "mel_path": str(f.mel)}, 400),
             ({"units": f.units, "mel_path": str(f.mel), "cid": "nope"}, 400)]
    for body, want in cases:
        code, out = _both(env, "POST", "/vocode", body)
        assert code == want, (body, out)
        if code == 200:
            assert out["num_samples"] == len(f.units) * 320


def _chunk(upload_id, payload, offset, index, total, total_size):
    fields = [("dzchunkbyteoffset", None, str(offset).encode()),
              ("dzchunkindex", None, str(index).encode()),
              ("dztotalchunkcount", None, str(total).encode()),
              ("dztotalfilesize", None, str(total_size).encode()),
              ("file", "long.npy", payload)]
    return (f"/dzupload?id={upload_id}", _multipart("l2sdz", fields),
            {"Content-Type": "multipart/form-data; boundary=l2sdz"})


def test_dzupload_route_matches_jax(env, monkeypatch):
    for mod in (jserver, tserver):
        monkeypatch.setattr(mod, "MAX_SEGMENT_S", 1.0)
    data = env.files.long.read_bytes()
    size = 3000
    pieces = [(i, data[o: o + size], o) for i, o in enumerate(range(0, len(data), size))]
    order = [len(pieces) - 1] + list(range(len(pieces) - 1))       # last chunk first
    for n, i in enumerate(order):
        idx, payload, off = pieces[i]
        path, body, headers = _chunk("up1", payload, off, idx, len(pieces), len(data))
        code, out = _both(env, "POST", path, body, headers)
        assert code == 200 and out["complete"] == (n == len(pieces) - 1)
        if n == 0:   # incomplete upload: a client error
            assert _both(env, "POST", "/vsg/synthesise", {"upload_id": "up1"})[0] == 400
    code, out = _both(env, "POST", "/vsg/synthesise", {"upload_id": "up1"})
    assert code == 200 and out["num_samples"] == 45 * 640
    assert _both(env, "POST", *_chunk("up2", b"abcdef", 0, 0, 1, 999))[0] == 500
    assert _both(env, "POST", *_chunk("bad_id", b"a", 0, 0, 1, 1))[0] == 400
    assert _both(env, "POST", *_chunk("up3", b"a", 0, 0, 1, tserver.MAX_UPLOAD_BYTES + 1))[0] == 413
    for srv in env.servers.values():          # oversize Content-Length, answered from the header
        conn = HTTPConnection("127.0.0.1", srv.server_address[1], timeout=TIMEOUT)
        conn.putrequest("POST", "/dzupload?id=up4")
        conn.putheader("Content-Length", str(tserver.MAX_CHUNK_BYTES + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()


def test_load_checkpoint_and_stats_match_jax(env):
    assert _both(env, "POST", "/load_checkpoint", {"name": "nope"})[0] == 400
    code, out = _both(env, "POST", "/load_checkpoint", {"name": "tiny2"})
    assert code == 200 and out["active"] == "tiny2"
    try:
        assert _both(env, "GET", "/checkpoints")[1]["active"] == "tiny2"
        assert _both(env, "POST", "/synthesise", {"video_path": str(env.files.clip2)})[0] == 200
    finally:
        assert _both(env, "POST", "/load_checkpoint", {"name": "tiny"})[0] == 200
    assert _both(env, "GET", "/stats")[1]["usage_count"] >= 1
    # a 404 route, then a 500 (a body that is not JSON) keeps serving
    assert _both(env, "POST", "/nope", {})[0] == 404
    assert _both(env, "POST", "/load_checkpoint", "not json")[0] == 500
    assert _both(env, "GET", "/health")[0] == 200


def test_main_serves_checkpoint_files(tmp_path, monkeypatch):
    """main() with --device cpu and --checkpoint files: the pipelines it
    builds (Lip2SpeechPipeline.from_checkpoints, port files) hold the files'
    weights; serve_forever is replaced so main returns."""
    s1, voc = _weights(5)
    ref = TorchPipeline.from_jax_variables(tcfg.preset("tiny"), s1, voc, device="cpu")
    checkpoint.save(tmp_path / "s1_00000001.pt", {"model": ref.model.state_dict()})
    checkpoint.save(tmp_path / "g_00000001", {"generator": ref.vocoder.state_dict()})
    served = []

    def serve_forever(self):
        served.append(self.RequestHandlerClass.state)
        self.server_close()

    monkeypatch.setattr(tserver.ThreadingHTTPServer, "serve_forever", serve_forever)
    tserver.main(["--port", "0", "--device", "cpu", "--db", str(tmp_path / "s.db"),
                  "--checkpoint", "a", "tiny", str(tmp_path / "s1_00000001.pt"),
                  str(tmp_path / "g_00000001"), "--bf16"])
    (state,) = served
    state.close()
    pipe = state.pipelines["a"]
    assert pipe.device == torch.device("cpu") and pipe.compute_dtype == torch.bfloat16
    for got, want in ((pipe.model, ref.model), (pipe.vocoder, ref.vocoder)):
        for k, v in want.state_dict().items():
            assert torch.equal(got.state_dict()[k], v.to(got.state_dict()[k].dtype)), k


def test_device_calls_run_on_one_thread(env):
    """The HTTP server starts a thread per request; the port makes every
    device call on its one device thread (PyTorch keeps cuDNN's execution
    plans per thread, so a fresh thread would build them again)."""
    pipe, threads = env.torch_pipes["tiny"], []
    orig = pipe.synthesise_batch

    def spy(*args):
        threads.append(threading.current_thread().name)
        return orig(*args)

    pipe.synthesise_batch = spy
    try:
        for _ in range(2):
            code, _out, _ = _request(env.servers["torch"], "POST", "/synthesise",
                                     {"video_path": str(env.files.clip2)})
            assert code == 200
    finally:
        pipe.synthesise_batch = orig
    assert len(threads) == 2 and len(set(threads)) == 1 and threads[0].startswith("device")


def test_vocode_method_matches_the_jax_vocoder(env):
    """Lip2SpeechPipeline.vocode against the JAX server's vocoder program on
    the same padded units, mel and speaker (the /vocode shapes): the float
    waveform within 1e-5 of max |ref|."""
    f = env.files
    rng = np.random.default_rng(4)
    code = np.zeros((1, 96), np.int32)
    code[0, :40] = f.units
    mel = rng.standard_normal((1, 192, 80)).astype(np.float32)
    spk = rng.standard_normal((1, 256)).astype(np.float32)
    jax_pipe = env.servers["jax"].RequestHandlerClass.state.pipelines["tiny"]
    ref = np.asarray(jserver._vocode_jit(jax_pipe.vocoder.cfg)(jax_pipe.vocoder_params, code,
                                                               mel, spk))
    got = env.torch_pipes["tiny"].vocode(code, mel, spk)
    assert got.shape == ref.shape == (1, 96 * 320) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_batcher_rows_equal_unbatched_calls(env):
    """Four concurrent requests of 3 lengths in one bucket: one device call
    at batch 4, each valid row within 1e-5 of its unbatched call."""
    pipe = env.torch_pipes["tiny"]
    rng = np.random.default_rng(6)
    clips = [rng.integers(0, 256, (n, 96, 96), dtype=np.uint8) for n in (30, 24, 24, 13)]
    spks = rng.standard_normal((4, 256)).astype(np.float32)
    state = tserver.ServerState({"tiny": pipe}, active="tiny")
    want = [tserver._synthesise_frames(state, c, s) for c, s in zip(clips, spks)]
    calls = []
    orig = pipe.synthesise_batch

    def spy(video, mask, spk):
        calls.append(video.shape)
        return orig(video, mask, spk)

    batcher = DynamicBatcher(pipe, max_batch=4, max_wait_ms=2000.0)
    results = [None] * 4
    try:
        pipe.synthesise_batch = spy
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, batcher.synthesise(clips[i], spks[i], timeout=TIMEOUT))) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
            assert not t.is_alive()
    finally:
        pipe.synthesise_batch = orig
        batcher.close()
        state.close()
    assert calls == [(4, 48, 88, 88, 1)]
    for res, ref, clip in zip(results, want, clips):
        assert res.wav.shape == ref.shape == (len(clip) * 640,)
        np.testing.assert_allclose(res.wav, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    with pytest.raises(ValueError, match="empty clip"):
        DynamicBatcher.synthesise(batcher, np.zeros((0, 96, 96), np.uint8), spks[0])


def test_streaming_out_of_order_frames(env):
    websockets = pytest.importorskip("websockets")
    from lip2speech_tpu_torch.pipeline.streaming import serve_streaming

    state = tserver.ServerState({"tiny": env.torch_pipes["tiny"]}, active="tiny")
    frames = np.random.default_rng(7).integers(0, 256, (12, 96, 96), dtype=np.uint8)
    want = tserver._synthesise_frames(state, frames, state.default_spk_emb)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    async def scenario():
        server = asyncio.create_task(serve_streaming(state, port=port))
        try:
            for _ in range(100):                  # until the endpoint listens
                try:
                    ws = await websockets.connect(f"ws://127.0.0.1:{port}", max_size=None,
                                                  open_timeout=TIMEOUT)
                    break
                except OSError:
                    await asyncio.sleep(0.01)
            async with ws:
                await ws.send(json.dumps({"type": "end_stream"}))
                err = json.loads(await asyncio.wait_for(ws.recv(), TIMEOUT))
                for i in np.random.default_rng(8).permutation(12):
                    await ws.send(json.dumps({
                        "type": "frame", "index": int(i), "height": 96, "width": 96,
                        "data": base64.b64encode(frames[i].tobytes()).decode()}))
                await ws.send(json.dumps({"type": "end_stream"}))
                return err, json.loads(await asyncio.wait_for(ws.recv(), TIMEOUT))
        finally:
            server.cancel()

    try:
        err, resp = asyncio.run(asyncio.wait_for(scenario(), TIMEOUT))
    finally:
        state.close()
    assert err == {"type": "error", "error": "no frames"}
    assert resp["type"] == "result" and resp["num_samples"] == 12 * 640
    got = np.frombuffer(base64.b64decode(resp["wav_base64"]), np.int16)
    np.testing.assert_array_equal(got, (np.clip(want, -1, 1) * 32767).astype(np.int16))
