"""Dynamic request batching for serving (JAX reference:
pipeline/batcher.py).

The reference serializes every request behind a global semaphore
(server.py:49-50): one clip per device call. A request at batch 1 leaves the
card mostly idle (the call is launch-bound), so this batcher collects
requests for up to `max_wait_ms` or until `max_batch` accumulate, groups
them by bucket length, and runs one device call per group.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from lip2speech_tpu_torch.data.stage1 import pick_bucket
from lip2speech_tpu_torch.data.transforms import prepare_video
from lip2speech_tpu_torch.pipeline.synthesise import Lip2SpeechPipeline, SynthesisResult


@dataclass
class _Request:
    frames: np.ndarray                 # (T, H, W) uint8
    spk_emb: np.ndarray                # (256,)
    done: threading.Event = field(default_factory=threading.Event)
    result: SynthesisResult | None = None
    error: Exception | None = None


class DynamicBatcher:
    def __init__(self, pipeline: Lip2SpeechPipeline,
                 max_batch: int = 8, max_wait_ms: float = 10.0):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def synthesise(self, frames: np.ndarray, spk_emb: np.ndarray,
                   timeout: float = 600.0) -> SynthesisResult:
        if len(frames) == 0:
            raise ValueError("empty clip")
        req = _Request(frames, spk_emb)
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("synthesis timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _collect(self) -> list[_Request]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        t0 = time.monotonic()
        while len(batch) < self.max_batch:
            remaining = self.max_wait - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self):
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            # group by bucket so each group is one device call
            groups: dict[int, list[_Request]] = {}
            for r in batch:
                groups.setdefault(pick_bucket(len(r.frames)), []).append(r)
            for bucket, reqs in groups.items():
                self._run_group(bucket, reqs)

    def _run_group(self, bucket: int, reqs: list[_Request]):
        try:
            cfg = self.pipeline.cfg
            size = cfg.video.mouth_size
            # pad the group to the next power of two, as the JAX batcher
            # does to bound its compiles. On CUDA a new batch size compiles
            # nothing; the pad stays for parity with the JAX package and so
            # that a CUDA graph captured per (pow2 batch, bucket) can serve
            # every group (ROADMAP §1.1). Dummy rows are fully masked ->
            # empty results, dropped by the zip below.
            b = 1 << (len(reqs) - 1).bit_length()
            video = np.zeros((b, bucket, size, size, 1), np.float32)
            mask = np.zeros((b, bucket), bool)
            spk = np.zeros((b, cfg.model.spk_emb_dim), np.float32)
            for i, r in enumerate(reqs):
                v = prepare_video(r.frames[: cfg.video.max_frames], size, train=False)
                video[i, : len(v), :, :, 0] = v
                mask[i, : len(v)] = True
                spk[i] = r.spk_emb
            results = self.pipeline.synthesise_batch(video, mask, spk)
            for r, res in zip(reqs, results):
                r.result = res
                r.done.set()
        except Exception as e:  # noqa: BLE001 — propagate to all waiters
            for r in reqs:
                r.error = e
                r.done.set()
