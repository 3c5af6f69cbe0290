"""The part of the reference client API that the CER tool drives: one
websocket connection a file, the reference client's first message, its
PCM frames and {"is_speaking": false}, and the text of the results.

Port copy of what tools/eval_cer.py needs from the repository's
clients/asr_client_api.py (AsrClient.transcribe_file), which imports the
JAX package's audio loader; this copy uses the port's. One difference:
that client resamples a file to 16 kHz and requantizes it as
trunc(x * 32767), which moves every non-zero 16-bit sample one step toward
zero. This copy sends a WAV's own samples at its own rate (audio_fs in the
first message; the server resamples as the in-process path does) and
requantizes as round(x * 32768), the inverse of the reader's
x = k / 32768, so the server decodes exactly the samples an in-process run
reads.
"""
from __future__ import annotations

import json
import os

import numpy as np

from asr2pass_tpu_torch.frontend.audio import load_audio_file, load_wav_bytes

# the reference client's defaults for the first message's fixed fields
CHUNK_SIZE = [5, 10, 5]
CHUNK_INTERVAL = 10
FS = 16000


async def transcribe_file(url: str, path: str, mode: str = "offline",
                          use_itn: bool = True) -> tuple:
    """Send a file to the server at url as 16-bit PCM (a WAV at its own
    rate, anything else read at 16 kHz) -> (text, audio seconds): the
    offline results' text, then any online text after the last of them."""
    import websockets

    if str(path).endswith(".wav"):
        with open(path, "rb") as f:
            wave, fs = load_wav_bytes(f.read())
    else:
        wave, fs = load_audio_file(path, FS), FS
    pcm = pcm16(wave)
    async with websockets.connect(url, max_size=1 << 30) as ws:
        await ws.send(json.dumps({
            "mode": mode, "chunk_size": CHUNK_SIZE,
            "chunk_interval": CHUNK_INTERVAL, "audio_fs": fs,
            "wav_name": os.path.basename(path), "wav_format": "pcm",
            "is_speaking": True, "hotwords": "{}", "itn": use_itn,
            "svs_lang": "auto", "svs_itn": True,
        }))
        stride = int(60 * CHUNK_SIZE[1] / CHUNK_INTERVAL / 1000 * fs * 2)
        for i in range(0, len(pcm), stride):
            await ws.send(pcm[i: i + stride])
        await ws.send(json.dumps({"is_speaking": False}))
        online = ""
        offline = ""
        while True:
            msg = json.loads(await ws.recv())
            if msg.get("mode", "").endswith("online"):
                online += msg.get("text", "")
            else:
                online = ""
                offline += msg.get("text", "")
            if msg.get("is_final"):
                break
    return offline + online, len(wave) / fs


def pcm16(wave) -> bytes:
    """Float samples -> little-endian 16-bit PCM, k = round(x * 32768)
    clipped to int16: a 16-bit WAV's samples come back unchanged."""
    x = np.clip(np.round(np.asarray(wave, np.float64) * 32768.0),
                -32768, 32767)
    return x.astype("<i2").tobytes()
