"""Streaming frame ingestion — the reference's SocketIO webcam path
(server.py:359-449: 'frame' events queue frames to Redis, 'end_stream'
assembles them and synthesizes) rebuilt on websockets, in-process; the
port's copy of the JAX package's pipeline/streaming.py, over the port's
ServerState.

Protocol (one websocket connection per stream):
  client -> {"type": "frame", "index": i, "data": <base64 raw gray bytes>,
             "height": H, "width": W}
  client -> {"type": "end_stream"}
  server -> {"type": "result", "num_samples": N, "wav_base64": ...}

Frames may arrive out of order (the reference re-sorts by index —
server.py:393-427); they are reassembled by index here too.
"""

from __future__ import annotations

import asyncio
import base64
import json

import numpy as np

from lip2speech_tpu_torch.pipeline.server import ServerState, _synthesise_frames


async def _handle(ws, state: ServerState):
    frames: dict[int, np.ndarray] = {}
    async for raw in ws:
        msg = json.loads(raw)
        if msg["type"] == "frame":
            buf = base64.b64decode(msg["data"])
            frame = np.frombuffer(buf, np.uint8).reshape(msg["height"], msg["width"])
            frames[int(msg["index"])] = frame
        elif msg["type"] == "end_stream":
            if not frames:
                await ws.send(json.dumps({"type": "error", "error": "no frames"}))
                continue
            ordered = np.stack([frames[i] for i in sorted(frames)])
            loop = asyncio.get_running_loop()
            if msg.get("detect_landmarks"):
                # raw webcam frames: in-process face box + mean-shape crop
                # (the reference detects per-frame via its dlib sidecar,
                # server.py:359-449)
                from lip2speech_tpu_torch.pipeline.landmarks import (
                    default_landmarker, extract_mouth_video)

                try:
                    ordered = await loop.run_in_executor(
                        None, lambda o=ordered: extract_mouth_video(
                            o, default_landmarker()))
                except ValueError as e:
                    await ws.send(json.dumps({"type": "error", "error": str(e)}))
                    frames.clear()
                    continue
            wav = await loop.run_in_executor(
                None, lambda: _synthesise_frames(
                    state, ordered, state.default_spk_emb))
            wav16 = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
            await ws.send(json.dumps({
                "type": "result",
                "num_samples": int(len(wav)),
                "sample_rate": 16000,
                "wav_base64": base64.b64encode(wav16.tobytes()).decode(),
            }))
            frames.clear()


async def serve_streaming(state: ServerState, host: str = "127.0.0.1",
                          port: int = 5007):
    import websockets

    async with websockets.serve(lambda ws: _handle(ws, state), host, port):
        await asyncio.Future()


def start_streaming_thread(state: ServerState, port: int = 5007):
    """Run the websocket endpoint on a daemon thread next to the HTTP server."""
    import threading

    def _run():
        asyncio.run(serve_streaming(state, port=port))

    t = threading.Thread(target=_run, daemon=True)
    t.start()
    return t
