"""HTTP serving gateway — the one-process replacement for the reference's
five-service mesh (SURVEY.md §3.1: Flask gateway + dlib Docker + decoder
GPU/CPU + vocoder + Redis, ports 5002-5006); the port's copy of the JAX
package's pipeline/server.py, with the same routes, JSON keys and status
codes, so a client of the JAX server works against this one unchanged.

Everything runs in ONE process: the end-to-end device call on the card
(`Lip2SpeechPipeline.synthesise_batch`), made on one device thread (or the
batcher's), plus a host-side worker thread consuming an in-process queue
(replacing Redis). Endpoints mirror the reference API surface:

  GET  /health            — liveness + device info
  GET  /checkpoints       — available model variants (inference_server.py:229)
  POST /load_checkpoint   — hot-swap the active pipeline (inference_server.py:152)
  POST /synthesise        — JSON {video_path, spk_emb_path?} -> wav (base64 or path)
  POST /vocode            — units + mel (+ speaker) -> wav, the vocoder alone
  POST /vsg/synthesise    — long video: chunk <= 23.5 s, synthesize, concat
                            (vsg_service.py:37-215 semantics)
  POST /dzupload?id=U     — Dropzone-style chunked upload (server.py:533-551):
                            multipart form with dzchunkbyteoffset/dzchunkindex/
                            dztotalchunkcount/dztotalfilesize + `file` part;
                            chunks assemble under the inputs dir, final chunk
                            verifies total size; /vsg/synthesise then accepts
                            {"upload_id": U}. Oversize requests get 413
                            (beyond-reference hardening: the reference caps
                            nothing).
  GET  /stats             — usage DB counters

stdlib http.server (no Flask needed); requests are serialized through a
single lock like the reference's global semaphore (server.py:49-50), unless
the dynamic batcher coalesces them. The pipelines run on the card unless
built with device="cpu" (`make_server(device=...)`, `--device`).
"""

from __future__ import annotations

import base64
import io
import json
import re
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from lip2speech_tpu_torch.core.config import PipelineConfig, preset
from lip2speech_tpu_torch.pipeline.db import DB
from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline
from lip2speech_tpu_torch.utils.audio_io import write_wav

MAX_SEGMENT_S = 23.5     # vsg_service.py:21
MAX_DURATION_S = 24.0    # config.py:30
FPS = 25
MAX_CHUNK_BYTES = 32 * 1024 * 1024      # per-/dzupload-request cap -> 413
MAX_UPLOAD_BYTES = 1024 * 1024 * 1024   # assembled-file cap -> 413
# upload ids: no underscore (the id/filename separator on disk), no glob
# metacharacters, no path separators
_UPLOAD_ID_RE = re.compile(r"[A-Za-z0-9-]{1,64}")


class ServerState:
    def __init__(self, pipelines: dict[str, Lip2SpeechPipeline],
                 active: str, db_path: str = ":memory:",
                 default_spk_emb: np.ndarray | None = None,
                 speaker_encoder=None,
                 use_batcher: bool = False, max_batch: int = 8,
                 max_wait_ms: float = 10.0, postprocess: bool = False,
                 inputs_dir: str | None = None,
                 default_audio_dir: str | None = None,
                 asr=None, static_dir: str | None = None):
        self.pipelines = pipelines
        self.active = active
        self.db = DB(db_path)
        # upload staging area (reference config.INPUTS_PATH)
        if inputs_dir is None:
            import tempfile

            inputs_dir = tempfile.mkdtemp(prefix="l2s_inputs_")
        self.inputs_dir = Path(inputs_dir)
        self.inputs_dir.mkdir(parents=True, exist_ok=True)
        self.lock = threading.Lock()      # global request serialization
        # one thread makes every device call: PyTorch keeps cuDNN's execution
        # plans per thread, so a call from a fresh thread (the HTTP server
        # starts one per request) builds them all again, which at B1 x 96 on
        # an H100 takes longer than the call itself (chip_smoke.py phase 19
        # times requests both ways)
        self._device_thread = ThreadPoolExecutor(max_workers=1,
                                                 thread_name_prefix="device")
        self.upload_lock = threading.Lock()  # /dzupload file writes only
        self.upload_chunks: dict[str, set[int]] = {}  # id -> received indices
        self.uploads_complete: set[str] = set()       # all chunks + size ok
        self.default_spk_emb = (default_spk_emb if default_spk_emb is not None
                                else np.zeros(256, np.float32))
        # in-process GE2E d-vector encoder (models/speaker.SpeakerEncoder, on
        # its own device) replacing the reference's speaker-embedding HTTP
        # sidecar (helpers.py:185-198)
        self.speaker_encoder = speaker_encoder
        # optional output post-processing: denoise + normalize every
        # synthesized waveform (reference server.py:316 rnnoise chain)
        self.postprocess = postprocess
        # default speaker-voice library (reference default_audios_list /
        # /audios + `aid` param, server.py:515-517): name -> 256-d embedding.
        # .npy files are precomputed embeddings; .wav files are embedded at
        # startup when the in-process GE2E encoder is available.
        self.default_audios: dict[str, np.ndarray] = {}
        if default_audio_dir:
            for f in sorted(Path(default_audio_dir).glob("*.npy")):
                self.default_audios[f.stem] = np.load(f).astype(np.float32)
            if speaker_encoder is not None:
                from lip2speech_tpu_torch.models.speaker import embed_utterance
                from lip2speech_tpu_torch.utils.audio_io import read_wav

                for f in sorted(Path(default_audio_dir).glob("*.wav")):
                    wav, sr = read_wav(f)
                    if wav.ndim > 1:
                        wav = wav.mean(axis=1)
                    self.default_audios[f.stem] = self.on_device(
                        embed_utterance, speaker_encoder, wav, sr)
        # optional Whisper ASR readback (reference server.py:341); None when
        # local weights are absent (zero-egress) — degrades gracefully
        self.asr = asr
        # /cdn/<file> static serving root (reference config.WEB_STATIC_PATH)
        self.static_dir = static_dir
        # optional dynamic batching: concurrent requests coalesce into one
        # device call instead of serializing behind the lock
        self.batchers: dict[str, "object"] = {}
        if use_batcher:
            from lip2speech_tpu_torch.pipeline.batcher import DynamicBatcher

            self.batchers = {name: DynamicBatcher(p, max_batch, max_wait_ms)
                             for name, p in pipelines.items()}

    @property
    def batcher(self):
        return self.batchers.get(self.active)

    def on_device(self, fn, *args):
        """fn(*args) on the server's device thread: its result, or its
        exception raised here. A pipeline with a serving mesh
        (--data-parallel) hands each call's rows on from there to its
        replicas' threads, one a device."""
        return self._device_thread.submit(fn, *args).result()

    def close(self) -> None:
        """Stop the batchers, the device thread and the pipelines' replica
        threads."""
        for b in self.batchers.values():
            b.close()
        self._device_thread.shutdown(wait=True)
        for p in self.pipelines.values():
            p.set_mesh(None)

    @property
    def pipeline(self) -> Lip2SpeechPipeline:
        return self.pipelines[self.active]


def _synthesise_frames(state: ServerState, frames: np.ndarray,
                       spk_emb: np.ndarray, cid: str | None = None) -> np.ndarray:
    """(T, H, W) uint8 pre-cropped mouth frames -> float32 wav.

    cid selects a loaded checkpoint for THIS request (reference `?cid=`,
    server.py:494); None uses the active one."""
    from lip2speech_tpu_torch.data.stage1 import pick_bucket
    from lip2speech_tpu_torch.data.transforms import prepare_video

    name = cid or state.active
    pipeline = state.pipelines[name]
    batcher = state.batchers.get(name)
    cfg = pipeline.cfg
    frames = frames[: int(MAX_DURATION_S * FPS)]
    if batcher is not None:
        res = batcher.synthesise(frames, spk_emb)
        return _postprocess(state, res.wav)
    video = prepare_video(frames, cfg.video.mouth_size, train=False)
    n = video.shape[0]
    t = pick_bucket(n)
    vb = np.zeros((1, t, video.shape[1], video.shape[2], 1), np.float32)
    vb[0, :n, :, :, 0] = video
    mask = np.zeros((1, t), bool)
    mask[0, :n] = True
    res = state.on_device(pipeline.synthesise_batch, vb, mask,
                          spk_emb[None].astype(np.float32))
    return _postprocess(state, res[0].wav)


def _postprocess(state: ServerState, wav: np.ndarray) -> np.ndarray:
    """Denoise + normalize on the active pipeline's device when the server
    post-processes; the float32 wav otherwise as it came."""
    if not state.postprocess:
        return wav
    from lip2speech_tpu_torch.ops.denoise import preprocess_audio

    def run():
        x = torch.as_tensor(np.asarray(wav, np.float32), device=state.pipeline.device)
        return preprocess_audio(x).cpu().numpy()

    return state.on_device(run)


def synthesise_long_video(state: ServerState, frames: np.ndarray,
                          spk_emb: np.ndarray, cid: str | None = None) -> np.ndarray:
    """VSG path: split into <= 23.5 s segments, synthesize each, concatenate."""
    seg_frames = int(MAX_SEGMENT_S * FPS)
    wavs = []
    for i in range(0, len(frames), seg_frames):
        chunk = frames[i : i + seg_frames]
        if len(chunk) == 0:
            break
        wavs.append(_synthesise_frames(state, chunk, spk_emb, cid))
    return np.concatenate(wavs) if wavs else np.zeros(0, np.float32)


def _wav_base64(wav: np.ndarray) -> str:
    """float wav in [-1, 1] -> base64 of a 16 kHz PCM16 WAV container."""
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())
    return base64.b64encode(buf.getvalue()).decode()


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser (stdlib-only; the `cgi` module is
    gone in modern Python). Returns (fields, files) where files maps part
    name -> (filename, bytes). Sufficient for Dropzone's chunk POSTs."""
    fields: dict[str, str] = {}
    files: dict[str, tuple[str, bytes]] = {}
    boundary = None
    for piece in content_type.split(";"):
        piece = piece.strip()
        if piece.startswith("boundary="):
            boundary = piece[len("boundary="):].strip('"')
    if not boundary:
        raise ValueError("multipart body without boundary")
    delim = b"--" + boundary.encode()
    # RFC 2046 framing: parts are delimited by CRLF + "--boundary". Splitting
    # on that exact sequence (and trimming ONE leading CRLF per part) keeps
    # payload bytes verbatim — a blanket strip(b"\r\n") would also eat
    # trailing 0x0D/0x0A bytes of binary payloads, truncating uploads.
    chunks = body.split(b"\r\n" + delim)
    if chunks and chunks[0].startswith(delim):
        chunks[0] = chunks[0][len(delim):]
    for part in chunks:
        if part.startswith(b"--") or not part.strip(b"\r\n"):
            continue  # closing "--" marker / preamble / epilogue
        if part.startswith(b"\r\n"):
            part = part[2:]
        header_blob, _, payload = part.partition(b"\r\n\r\n")
        disp = ""
        for line in header_blob.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition"):
                disp = line.decode(errors="replace")
        name, filename = None, None
        for attr in disp.split(";"):
            attr = attr.strip()
            if attr.startswith("name="):
                name = attr[5:].strip('"')
            elif attr.startswith("filename="):
                filename = attr[9:].strip('"')
        if name is None:
            continue
        if filename is not None:
            files[name] = (filename, payload)
        else:
            fields[name] = payload.decode(errors="replace")
    return fields, files


def _device_names(pipelines: dict[str, Lip2SpeechPipeline]) -> list[str]:
    """The devices the pipelines run on: the card's name for each CUDA
    device, "cpu" for the CPU."""
    names = []
    for dev in sorted({p.device for p in pipelines.values()}, key=str):
        name = (torch.cuda.get_device_name(dev.index or 0) if dev.type == "cuda"
                else dev.type)
        if name not in names:
            names.append(name)
    return names


class Handler(BaseHTTPRequestHandler):
    state: ServerState = None  # set by make_server

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length) if length else b"{}"
        return json.loads(raw or b"{}")

    def do_GET(self):
        if self.path in ("/demo", "/vsg"):
            port = getattr(self.state, "streaming_port", None)
            page = DEMO_HTML if self.path == "/demo" else VSG_HTML
            body = page.replace("__STREAM_PORT__", str(port or 0)).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/health":
            self._json(200, {"status": "ok",
                             "devices": _device_names(self.state.pipelines),
                             "active_checkpoint": self.state.active})
        elif self.path == "/checkpoints":
            self._json(200, {"checkpoints": sorted(self.state.pipelines),
                             "active": self.state.active})
        elif self.path == "/audios":
            # default speaker-voice library (reference server.py:515-517)
            self._json(200, {"audios": sorted(self.state.default_audios)})
        elif self.path.startswith(("/video/", "/audio/")):
            # id -> static-file redirect (reference server.py:519-525)
            from urllib.parse import unquote, urlparse

            kind, _, rid = urlparse(self.path).path[1:].partition("/")
            rid = unquote(rid)
            if not rid or "/" in rid:
                self._json(404, {"error": "not found"})
                return
            ext = ".mp4" if kind == "video" else ".wav"
            # re-quote the decoded id: raw CRLF/unicode in a header is
            # response splitting / a UnicodeEncodeError mid-response
            from urllib.parse import quote

            self.send_response(302)
            self.send_header("Location", f"/cdn/{quote(rid)}{ext}")
            self.end_headers()
        elif self.path.startswith("/cdn/"):
            # static file serving (reference server.py:471-473); resolve()
            # must stay inside static_dir — no traversal
            from urllib.parse import unquote, urlparse

            static_dir = getattr(self.state, "static_dir", None)
            if static_dir is None:
                self._json(404, {"error": "no static dir configured"})
                return
            # strip ?query and decode %-escapes: browser URLs carry both
            rel = unquote(urlparse(self.path).path[len("/cdn/"):])
            try:
                target = (Path(static_dir) / rel).resolve()
                ok = (str(target).startswith(
                    str(Path(static_dir).resolve()) + "/")
                    and target.is_file())
            except (ValueError, OSError):   # e.g. %00 -> embedded NUL
                ok = False
            if not ok:
                self._json(404, {"error": "not found"})
                return
            import mimetypes

            body = target.read_bytes()
            ctype = mimetypes.guess_type(target.name)[0] or "application/octet-stream"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/stats":
            self._json(200, {"usage_count": self.state.db.usage_count()})
        else:
            self._json(404, {"error": "not found"})

    def do_POST(self):
        try:
            if self.path == "/load_checkpoint":
                body = self._read_body()
                name = body.get("name")
                if name not in self.state.pipelines:
                    self._json(400, {"error": f"unknown checkpoint {name!r}",
                                     "available": sorted(self.state.pipelines)})
                    return
                with self.state.lock:
                    self.state.active = name
                self._json(200, {"active": name})
            elif self.path.split("?")[0] in ("/synthesise", "/vsg/synthesise"):
                self._handle_synthesise(long_video=self.path.startswith("/vsg"))
            elif self.path.split("?")[0] == "/vocode":
                self._handle_vocode()
            elif self.path.split("?")[0] == "/dzupload":
                self._handle_dzupload()
            else:
                self._json(404, {"error": "not found"})
        except Exception as e:  # reference: global handler -> 500 (server.py:462)
            self._json(500, {"error": str(e)})

    def _handle_dzupload(self):
        """Dropzone chunked upload (reference server.py:533-551): append each
        chunk at dzchunkbyteoffset, verify total size on the last chunk.
        Adds the size caps the reference lacks (413 on oversize)."""
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        upload_id = (q.get("id") or [None])[0]
        # strict id charset: no underscore (the id/filename separator), no
        # glob metacharacters (_resolve_upload matches by prefix), no slashes
        if not upload_id or not _UPLOAD_ID_RE.fullmatch(upload_id):
            self._json(400, {"error": "missing or invalid upload id"})
            return
        length = int(self.headers.get("Content-Length", 0))
        if length > MAX_CHUNK_BYTES:
            self._json(413, {"error": f"chunk exceeds {MAX_CHUNK_BYTES} bytes"})
            return
        raw = self.rfile.read(length)
        ctype = self.headers.get("Content-Type", "")
        if "multipart/form-data" in ctype:
            fields, files = _parse_multipart(raw, ctype)
            if "file" not in files:
                self._json(400, {"error": "no `file` part in upload"})
                return
            filename, payload = files["file"]
        else:
            # raw-binary convenience mode: metadata in the query string
            fields = {k: v[0] for k, v in q.items()}
            filename, payload = fields.get("filename", "upload.mp4"), raw
        filename = Path(filename).name or "upload.mp4"
        try:
            offset = int(fields.get("dzchunkbyteoffset", 0))
            index = int(fields.get("dzchunkindex", 0))
            total_chunks = int(fields.get("dztotalchunkcount", 1))
            total_size = int(fields.get("dztotalfilesize", len(payload)))
        except ValueError:
            self._json(400, {"error": "malformed dz* chunk fields"})
            return
        if total_size > MAX_UPLOAD_BYTES or offset + len(payload) > MAX_UPLOAD_BYTES:
            self._json(413, {"error": f"upload exceeds {MAX_UPLOAD_BYTES} bytes"})
            return
        upload_path = self.state.inputs_dir / f"{upload_id}_{filename}"
        # dedicated upload mutex: chunk writes must not queue behind a running
        # synthesis (state.lock is held for the whole device call)
        with self.state.upload_lock:
            # NOT "ab": append mode ignores seek() on POSIX, so out-of-order
            # chunks would corrupt the file (latent in reference server.py:539)
            mode = "r+b" if upload_path.exists() else "wb"
            with open(upload_path, mode) as f:
                f.seek(offset)
                f.write(payload)
            got = self.state.upload_chunks.setdefault(upload_id, set())
            got.add(index)
            # verify once EVERY chunk index has arrived (chunks may come out
            # of order, so "index == last" is not "upload finished"); st_size
            # alone can't catch holes — a seek past EOF creates a sparse file
            # of the full declared size
            if len(got) == total_chunks:
                if upload_path.stat().st_size != total_size:
                    # reference returns 500 'File size mismatch' (server.py:548)
                    self._json(500, {"error": "file size mismatch"})
                    return
                self.state.uploads_complete.add(upload_id)
        self._json(200, {"message": "chunk uploaded successfully",
                         "upload_id": upload_id,
                         "complete": upload_id in self.state.uploads_complete})

    def _resolve_upload(self, upload_id: str) -> str:
        if not _UPLOAD_ID_RE.fullmatch(upload_id):
            raise FileNotFoundError(f"invalid upload id {upload_id!r}")
        if (upload_id in self.state.upload_chunks
                and upload_id not in self.state.uploads_complete):
            raise FileNotFoundError(
                f"upload {upload_id!r} is incomplete (missing chunks)")
        # exact-prefix listdir match — NOT glob (a client-supplied pattern
        # must never wildcard into other requests' staged files)
        cands = sorted(f for f in self.state.inputs_dir.iterdir()
                       if f.name.startswith(f"{upload_id}_"))
        if not cands:
            raise FileNotFoundError(f"no uploaded file for id {upload_id!r}")
        return str(cands[0])

    def _handle_vocode(self):
        """Vocoder-only synthesis: units + mel (+ speaker) -> wav, the API of
        the reference's standalone vocoder service (POST /vocoder, port 5005,
        inference_server.py:149-215). Accepts inline `units` or a `unt_path`
        (one line of space-separated unit ids), a `mel_path` .npy (Tm, 80)
        with Tm == 2*len(units), and the usual speaker options."""
        from urllib.parse import parse_qs, urlparse

        from lip2speech_tpu_torch.data.stage1 import pick_bucket

        q = {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}
        body = self._read_body()
        cid = q.get("cid") or body.get("cid")
        if cid is not None and cid not in self.state.pipelines:
            self._json(400, {"error": f"unknown checkpoint {cid!r}",
                             "available": sorted(self.state.pipelines)})
            return
        pipeline = self.state.pipelines[cid or self.state.active]
        # shapes come from the SERVING config, not hard-coded defaults:
        # code_hop_size = samples per 50-Hz unit (320 for the reference
        # stack: 2 conditioning rows x total_upsample 160 per row),
        # mel_bins = model_in_dim minus the code + speaker slots (80)
        vcfg = pipeline.cfg.vocoder
        hop = vcfg.code_hop_size
        mel_bins = vcfg.model_in_dim - 2 * vcfg.embedding_dim
        try:
            if "units" in body:
                units = np.asarray(body["units"], np.int32)
            else:
                units = np.asarray(
                    Path(body["unt_path"]).read_text().split(), np.int32)
            if units.ndim != 1:
                raise ValueError(f"units must be a flat list, "
                                 f"got shape {units.shape}")
            mel = np.load(body["mel_path"]).astype(np.float32)
            if mel.ndim != 2 or mel.shape[1] != mel_bins:
                raise ValueError(
                    f"mel must be (T, {mel_bins}), got {mel.shape}")
            if abs(mel.shape[0] - 2 * len(units)) > 4:
                raise ValueError(f"{len(units)} units vs {mel.shape[0]} mel "
                                 f"frames (need Tm ~= 2*units)")
            if "spk_emb_path" in body:
                spk = np.load(body["spk_emb_path"]).astype(np.float32)
                if spk.ndim != 1:
                    raise ValueError(f"spk_emb must be 1-D, got {spk.shape}")
            else:
                spk = self.state.default_spk_emb
            # pad to the serving bucket grid (static shapes; 2 units/frame)
            n = len(units)
            tc = 2 * pick_bucket((n + 1) // 2)
            if n > tc:
                raise ValueError(f"{n} units exceeds the max serving "
                                 f"bucket ({tc}); chunk via /vsg/synthesise")
        except Exception as e:  # bad client input
            self._json(400, {"error": f"cannot load inputs: {e}"})
            return
        code = np.zeros((1, tc), np.int32)
        code[0, :n] = units
        melb = np.zeros((1, 2 * tc, mel_bins), np.float32)
        melb[0, :min(mel.shape[0], 2 * tc)] = mel[:2 * tc]
        t0 = time.time()
        # the pipeline's own vocoder, in its dtype: the same module (and
        # trio kernel) that /synthesise runs
        with self.state.lock:  # global device serialization (server.py:26)
            wav = self.state.on_device(pipeline.vocode, code, melb,
                                       spk[None].astype(np.float32))[0, :n * hop]
        elapsed = time.time() - t0
        out = {"sample_rate": 16000, "num_samples": int(len(wav)),
               "elapsed_s": round(elapsed, 4),
               "rtf": round((len(wav) / 16000.0) / max(elapsed, 1e-9), 2)}
        if body.get("output_path"):
            write_wav(body["output_path"], wav, 16000)
            out["output_path"] = body["output_path"]
        else:
            out["wav_base64"] = _wav_base64(wav)
        self._json(200, out)

    def _handle_synthesise(self, long_video: bool):
        from urllib.parse import parse_qs, urlparse

        from lip2speech_tpu_torch.data.video_io import load_video_gray

        # request options ride the query string exactly like the reference
        # (?cid=&aid=&close_up=&asr=&log=, server.py:494-508)
        q = {k: v[0] for k, v in parse_qs(urlparse(self.path).query).items()}
        ctype = self.headers.get("Content-Type", "")
        uploaded_audio = None
        if "multipart/form-data" in ctype:
            # direct file upload (reference server.py:490-498): required
            # `video` part, optional `audio` part for the speaker voice
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_CHUNK_BYTES:
                self._json(413, {"error": f"upload exceeds {MAX_CHUNK_BYTES} "
                                          f"bytes; use /dzupload"})
                return
            fields, files = _parse_multipart(self.rfile.read(length), ctype)
            if "video" not in files:
                self._json(400, {"error": "no `video` part in upload"})
                return
            import uuid

            uid = uuid.uuid4().hex
            vname, vbytes = files["video"]
            vpath = self.state.inputs_dir / f"{uid}{Path(vname).suffix or '.mp4'}"
            vpath.write_bytes(vbytes)
            body: dict = dict(fields)
            body["video_path"] = str(vpath)
            if "audio" in files:
                apath = self.state.inputs_dir / f"{uid}.wav"
                apath.write_bytes(files["audio"][1])
                uploaded_audio = apath
        else:
            body = self._read_body()
        cid = q.get("cid") or body.get("cid")
        if cid is not None and cid not in self.state.pipelines:
            self._json(400, {"error": f"unknown checkpoint {cid!r}",
                             "available": sorted(self.state.pipelines)})
            return
        t0 = time.time()
        try:
            # /vsg/synthesise accepts a previously /dzupload-ed id in place
            # of a server-local path (reference server.py:553-560)
            path = (self._resolve_upload(body["upload_id"])
                    if "upload_id" in body else body["video_path"])
            frames = load_video_gray(path)
        except Exception as e:  # bad client input, not a server fault
            self._json(400, {"error": f"cannot load video: {e}"})
            return
        if q.get("close_up") == "0" and "landmarks_path" not in body:
            # reference close_up=0 means "not a mouth close-up": run the
            # face/landmark path before cropping (server.py:230-273)
            body["detect_landmarks"] = True
        if not long_video and len(frames) > MAX_DURATION_S * FPS:
            # reject before touching the device or taking the lock
            self._json(400, {"error": f"video longer than {MAX_DURATION_S}s; "
                                      f"use /vsg/synthesise"})
            return
        if "landmarks_path" in body:
            # raw (uncropped) video + landmarks: crop the mouth ROI in-process
            from lip2speech_tpu_torch.pipeline.landmarks import (
                PrecomputedLandmarks, extract_mouth_video)

            frames = extract_mouth_video(
                frames, PrecomputedLandmarks(body["landmarks_path"]))
        elif body.get("detect_landmarks"):
            # raw video, NO landmarks: in-process dlib-free detector
            # (replaces the reference's dlib sidecar service,
            # face_landmarks_server.py:55-347) — trained cascade when
            # available, saliency heuristic otherwise
            from lip2speech_tpu_torch.pipeline.landmarks import (
                default_landmarker, extract_mouth_video)

            try:
                frames = extract_mouth_video(frames, default_landmarker())
            except ValueError as e:   # no face found in any frame
                self._json(400, {"error": str(e)})
                return
        if uploaded_audio is not None and "spk_wav_path" not in body:
            body["spk_wav_path"] = str(uploaded_audio)
        aid = q.get("aid") or body.get("aid")
        if "spk_emb_path" in body:
            spk = np.load(body["spk_emb_path"]).astype(np.float32)
        elif "spk_wav_path" in body and self.state.speaker_encoder is not None:
            from lip2speech_tpu_torch.models.speaker import embed_utterance
            from lip2speech_tpu_torch.utils.audio_io import read_wav

            wav, sr = read_wav(body["spk_wav_path"])
            if wav.ndim > 1:
                wav = wav.mean(axis=1)
            spk = self.state.on_device(embed_utterance, self.state.speaker_encoder, wav, sr)
        elif aid is not None:
            # named default voice (reference `aid` param, server.py:503)
            if aid not in self.state.default_audios:
                self._json(400, {"error": f"unknown audio id {aid!r}",
                                 "available": sorted(self.state.default_audios)})
                return
            spk = self.state.default_audios[aid]
        else:
            spk = self.state.default_spk_emb

        import contextlib

        # with the dynamic batcher, requests coalesce instead of serializing
        guard = (contextlib.nullcontext()
                 if self.state.batchers.get(cid or self.state.active) is not None
                 else self.state.lock)
        with guard:
            if long_video:
                wav = synthesise_long_video(self.state, frames, spk, cid)
            else:
                wav = _synthesise_frames(self.state, frames, spk, cid)

        elapsed = time.time() - t0
        if q.get("log", "1") != "0":   # reference log_result flag
            self.state.db.log_usage(len(frames) / FPS, elapsed)

        out: dict = {"sample_rate": 16000, "num_samples": int(len(wav)),
                     "elapsed_s": round(elapsed, 4)}
        if q.get("asr", "1") != "0" and self.state.asr is not None:
            # Whisper readback of the synthesized speech (server.py:341)
            try:
                out["asr_text"] = self.state.asr.run(wav)
            except Exception as e:  # noqa: BLE001 — readback must not fail synthesis
                out["asr_error"] = str(e)
        if long_video and body.get("email"):
            # VSG completion notification (reference vsg_service.py:126-135);
            # best-effort — SMTP creds come from EMAIL_* env vars
            from lip2speech_tpu_torch.utils.email_client import send_email

            try:
                out["email_sent"] = send_email(
                    "VSG synthesis complete",
                    f"Your {len(frames) / FPS:.1f}s video was synthesised "
                    f"in {elapsed:.1f}s ({len(wav)} samples).",
                    receivers=[body["email"]])
            except Exception as e:  # noqa: BLE001 — notify must not fail the request
                out["email_sent"] = False
                out["email_error"] = str(e)
        if body.get("output_path"):
            write_wav(body["output_path"], wav, 16000)
            out["output_path"] = body["output_path"]
        else:
            out["wav_base64"] = _wav_base64(wav)
        self._json(200, out)


# Demo page (reference templates/demo.html + vsg.html equivalent):
# path-based synthesis + a webcam capture UI streaming frames over the
# websocket endpoint (reference SocketIO 'frame'/'end_stream' path).
DEMO_HTML = """<!doctype html>
<html><head><title>lip2speech-tpu demo</title><style>
body{font-family:sans-serif;max-width:640px;margin:2em auto}
input{width:100%;margin:4px 0;padding:6px}button{padding:8px 16px}
</style></head><body>
<h2>lip2speech-tpu</h2>
<p>Silent mouth-ROI video &rarr; 16 kHz speech, one device call on the card.</p>
<label>Video path (server-local .npy/.mp4)</label><input id="v">
<label>Speaker wav path (optional)</label><input id="s">
<label>Landmarks path (optional, raw video)</label><input id="l">
<label>Checkpoint</label><select id="cid"></select>
<label>Default voice</label><select id="aid"><option value="">(built-in)</option></select>
<button onclick="go()">Synthesise</button>
<p id="status"></p><audio id="player" controls></audio>
<h3>Webcam streaming</h3>
<button id="wstart" onclick="startCam()">Start webcam</button>
<button id="wstop" onclick="stopCam()" disabled>Stop &amp; synthesise</button>
<video id="cam" width="160" height="120" autoplay muted playsinline></video>
<canvas id="cap" width="160" height="120" style="display:none"></canvas>
<p id="wstatus"></p><audio id="wplayer" controls></audio>
<script>
// populate checkpoint + default-voice selectors (reference demo.html
// template params checkpoint_ids / default_audios)
fetch('/checkpoints').then(r=>r.json()).then(j=>{
  const sel=document.getElementById('cid');
  for(const c of j.checkpoints){const o=document.createElement('option');
    o.value=c;o.textContent=c;o.selected=(c===j.active);sel.appendChild(o);}});
fetch('/audios').then(r=>r.json()).then(j=>{
  const sel=document.getElementById('aid');
  for(const a of j.audios){const o=document.createElement('option');
    o.value=a;o.textContent=a;sel.appendChild(o);}});
async function go(){
  const body={video_path:document.getElementById('v').value};
  const s=document.getElementById('s').value; if(s) body.spk_wav_path=s;
  const l=document.getElementById('l').value; if(l) body.landmarks_path=l;
  const cid=document.getElementById('cid').value; if(cid) body.cid=cid;
  const aid=document.getElementById('aid').value; if(aid) body.aid=aid;
  document.getElementById('status').textContent='synthesising...';
  const r=await fetch('/synthesise',{method:'POST',body:JSON.stringify(body)});
  const j=await r.json();
  if(!r.ok){document.getElementById('status').textContent='error: '+j.error;return;}
  document.getElementById('status').textContent=
    j.num_samples+' samples in '+j.elapsed_s+'s';
  const wav=Uint8Array.from(atob(j.wav_base64),c=>c.charCodeAt(0));
  document.getElementById('player').src=
    URL.createObjectURL(new Blob([wav],{type:'audio/wav'}));
}
let ws=null,timer=null,idx=0;
function b64(bytes){let s='';for(let i=0;i<bytes.length;i+=4096)
  s+=String.fromCharCode.apply(null,bytes.subarray(i,i+4096));return btoa(s);}
function startCam(){
  const port=__STREAM_PORT__;
  const st=document.getElementById('wstatus');
  if(!port){st.textContent='start the server with --streaming-port';return;}
  navigator.mediaDevices.getUserMedia({video:{width:160,height:120}}).then(stream=>{
    const v=document.getElementById('cam');v.srcObject=stream;
    ws=new WebSocket('ws://'+location.hostname+':'+port);
    ws.onmessage=ev=>{const m=JSON.parse(ev.data);
      if(m.type==='result'){st.textContent=m.num_samples+' samples';
        document.getElementById('wplayer').src=
          URL.createObjectURL(pcm16ToWav(m.wav_base64,m.sample_rate));}
      else if(m.type==='error'){st.textContent='error: '+m.error;}};
    ws.onopen=()=>{idx=0;
      const c=document.getElementById('cap'),ctx=c.getContext('2d');
      timer=setInterval(()=>{ctx.drawImage(v,0,0,160,120);
        const d=ctx.getImageData(0,0,160,120).data;
        const g=new Uint8Array(160*120);
        for(let i=0;i<g.length;i++)
          g[i]=(d[4*i]*299+d[4*i+1]*587+d[4*i+2]*114)/1000;
        ws.send(JSON.stringify({type:'frame',index:idx++,width:160,
          height:120,data:b64(g)}));},40);   // 25 fps (reference config FPS)
      document.getElementById('wstart').disabled=true;
      document.getElementById('wstop').disabled=false;
      st.textContent='streaming at 25 fps...';};
  }).catch(e=>{st.textContent='webcam: '+e;});
}
function stopCam(){
  clearInterval(timer);
  const v=document.getElementById('cam');
  if(v.srcObject){v.srcObject.getTracks().forEach(t=>t.stop());v.srcObject=null;}
  document.getElementById('wstatus').textContent='synthesising...';
  ws.send(JSON.stringify({type:'end_stream',detect_landmarks:true}));
  document.getElementById('wstart').disabled=false;
  document.getElementById('wstop').disabled=true;
}
function pcm16ToWav(b,rate){
  const pcm=Uint8Array.from(atob(b),c=>c.charCodeAt(0));
  const h=new ArrayBuffer(44);const dv=new DataView(h);
  const w=(o,s)=>{for(let i=0;i<s.length;i++)dv.setUint8(o+i,s.charCodeAt(i));};
  w(0,'RIFF');dv.setUint32(4,36+pcm.length,true);w(8,'WAVEfmt ');
  dv.setUint32(16,16,true);dv.setUint16(20,1,true);dv.setUint16(22,1,true);
  dv.setUint32(24,rate,true);dv.setUint32(28,rate*2,true);
  dv.setUint16(32,2,true);dv.setUint16(34,16,true);w(36,'data');
  dv.setUint32(40,pcm.length,true);
  return new Blob([h,pcm],{type:'audio/wav'});
}
</script></body></html>"""

# VSG long-video page (reference templates/vsg.html): chunked upload of a
# large video (1 MB chunks, the reference's Dropzone chunkSize) to /dzupload,
# then POST /vsg/synthesise with the upload id + optional email notify.
VSG_HTML = """<!doctype html>
<html><head><title>lip2speech-tpu VSG</title><style>
body{font-family:sans-serif;max-width:640px;margin:2em auto}
input{width:100%;margin:4px 0;padding:6px}button{padding:8px 16px}
progress{width:100%}
</style></head><body>
<h2>Video-to-speech generation (long videos)</h2>
<ul><li>Upload a silent video (chunked, any length up to the server cap)</li>
<li>It is synthesised in &le;23.5 s segments and concatenated</li>
<li>Optionally get an email when it completes</li></ul>
<input id="file" type="file" accept="video/*,.npy">
<input id="email" type="email" placeholder="Email (optional)">
<button onclick="go()">Upload &amp; synthesise</button>
<progress id="prog" value="0" max="1"></progress>
<p id="status"></p><audio id="player" controls></audio>
<script>
const CHUNK=1000000;  // 1 MB, reference vsg.html chunkSize
async function go(){
  const f=document.getElementById('file').files[0];
  const st=document.getElementById('status');
  if(!f){st.textContent='choose a file first';return;}
  const id=Math.random().toString(36).slice(2,10);
  const total=Math.ceil(f.size/CHUNK);
  for(let i=0;i<total;i++){
    const off=i*CHUNK, blob=f.slice(off,off+CHUNK);
    const q='/dzupload?id='+id+'&filename='+encodeURIComponent(f.name)+
      '&dzchunkbyteoffset='+off+'&dzchunkindex='+i+
      '&dztotalchunkcount='+total+'&dztotalfilesize='+f.size;
    const r=await fetch(q,{method:'POST',body:blob});
    if(!r.ok){st.textContent='upload error: '+(await r.json()).error;return;}
    document.getElementById('prog').value=(i+1)/total;
  }
  st.textContent='synthesising...';
  const body={upload_id:id};
  const em=document.getElementById('email').value; if(em) body.email=em;
  const r=await fetch('/vsg/synthesise',{method:'POST',body:JSON.stringify(body)});
  const j=await r.json();
  if(!r.ok){st.textContent='error: '+j.error;return;}
  st.textContent=j.num_samples+' samples in '+j.elapsed_s+'s'+
    (j.email_sent?' (email sent)':'');
  const wav=Uint8Array.from(atob(j.wav_base64),c=>c.charCodeAt(0));
  document.getElementById('player').src=
    URL.createObjectURL(new Blob([wav],{type:'audio/wav'}));
}
</script></body></html>"""


def make_server(port: int = 5002,
                pipelines: dict[str, Lip2SpeechPipeline] | None = None,
                cfg: PipelineConfig | None = None,
                db_path: str = ":memory:",
                use_batcher: bool = False,
                device: str | torch.device | None = None,
                **state_kw) -> ThreadingHTTPServer:
    """The HTTP server over `pipelines` (name -> pipeline; the first name in
    sorted order is active). Without pipelines it builds one random-weight
    `multi_target` pipeline (or `cfg`'s) on `device`: the card unless
    device="cpu", and with no card and no device it raises."""
    if pipelines is None:
        cfg = cfg or preset("multi_target")
        pipelines = {"multi_target": Lip2SpeechPipeline.initialize_random(cfg, device=device)}
    elif device is not None:
        # already-built pipelines sit on their own device; silently
        # ignoring the argument would contradict the caller
        raise ValueError("device only applies when make_server builds the pipeline; "
                         "pass it to the Lip2SpeechPipeline constructor instead")
    state = ServerState(pipelines, active=sorted(pipelines)[0], db_path=db_path,
                        use_batcher=use_batcher, **state_kw)
    handler = type("BoundHandler", (Handler,), {"state": state})
    return ThreadingHTTPServer(("127.0.0.1", port), handler)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--port", type=int, default=5002)
    p.add_argument("--db", default="server.db")
    p.add_argument("--checkpoint", nargs=4, action="append", default=[],
                   metavar=("NAME", "PRESET", "STAGE1", "VOCODER"),
                   help="register a real-weight pipeline: a display name, a "
                        "config preset, and stage-1 + vocoder checkpoint files "
                        "(port s1_* / g_* files, or reference .pt files "
                        "converted on load; a JAX orbax directory is converted "
                        "first with scripts/orbax_to_torch.py). Repeatable; the "
                        "reference decoder server preloads its checkpoint list "
                        "the same way (inference_server.py:106-176). Without "
                        "this flag a random-weight smoke pipeline is served.")
    p.add_argument("--bf16", action="store_true",
                   help="serve in bfloat16 (casts weights+activations)")
    p.add_argument("--batcher", action="store_true",
                   help="coalesce concurrent requests into batched device calls")
    p.add_argument("--warmup", action="store_true",
                   help="run every serving bucket once before accepting traffic")
    p.add_argument("--streaming-port", type=int, default=0,
                   help="also serve the websocket frame-streaming endpoint")
    p.add_argument("--data-parallel", action="store_true",
                   help="split request batches over every local card (a replica "
                        "of each pipeline a card; with --device, that device)")
    p.add_argument("--default-audio-dir",
                   help="directory of default speaker voices (.npy 256-d "
                        "embeddings / .wav files); served at /audios, "
                        "selected per request with ?aid=NAME")
    p.add_argument("--asr-model",
                   help="local Whisper weights for the ASR readback of "
                        "synthesized speech (?asr=1; absent -> skipped)")
    p.add_argument("--static-dir",
                   help="serve files under this directory at /cdn/<name> "
                        "(reference WEB_STATIC_PATH)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)
    dtype = torch.bfloat16 if args.bf16 else None
    if args.checkpoint:
        pipelines = {}
        for name, preset_name, s1_path, voc_path in args.checkpoint:
            print(f"loading pipeline {name!r} (preset {preset_name}): "
                  f"stage1={s1_path} vocoder={voc_path}")
            pipelines[name] = Lip2SpeechPipeline.from_checkpoints(
                preset(preset_name), s1_path, voc_path, compute_dtype=dtype,
                emit_int16=False, device=args.device)
    else:
        print("WARNING: no --checkpoint given; serving RANDOM weights "
              "(smoke-test mode)")
        pipelines = {"multi_target": Lip2SpeechPipeline.initialize_random(
            preset("multi_target"), compute_dtype=dtype, device=args.device)}
    from lip2speech_tpu_torch.eval.asr import try_load_asr

    server = make_server(args.port, pipelines=pipelines, db_path=args.db,
                         use_batcher=args.batcher,
                         default_audio_dir=args.default_audio_dir,
                         asr=try_load_asr(args.asr_model, device=args.device),
                         static_dir=args.static_dir)
    state = server.RequestHandlerClass.state
    if args.data_parallel:
        from lip2speech_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(devices=None if args.device is None else [args.device])
        print(f"data-parallel serving over {mesh.shape['data']} devices")
        for pipeline in pipelines.values():
            pipeline.set_mesh(mesh)
    if args.warmup:
        print("warming up (serving buckets)...")
        # with the batcher on, device calls come in pow2 group sizes
        # (batcher._run_group) — warm those shapes too
        sizes = (1, 2, 4, 8) if args.batcher else (1,)
        state.pipeline.warmup(batch_sizes=sizes)
    if args.streaming_port:
        from lip2speech_tpu_torch.pipeline.streaming import start_streaming_thread

        start_streaming_thread(state, port=args.streaming_port)
        state.streaming_port = args.streaming_port   # advertised in /demo
        print(f"streaming on :{args.streaming_port}")
    print(f"serving on :{args.port} ({_device_names(pipelines)})")
    server.serve_forever()


if __name__ == "__main__":
    main()
