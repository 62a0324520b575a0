"""Async ASR worker (port of ``gofr_tpu/serving/asr.py``): Pub/Sub-fed
Whisper transcription. Jobs arrive on a broker topic; the handler binds
the audio payload, runs the log-mel frontend and greedy ``transcribe`` in
the executor on the device the params live on, and publishes the result
to the job's reply topic (commit on success: at-least-once).

Job message (JSON): ``{"id": ..., "audio": [f32 samples] | "audio_b64":
base64 f32le, "sample_rate": 16000, "reply_topic": "asr-results",
"max_tokens": N}``. Wire-up: ``app.subscribe("asr-jobs", worker.handler)``.
"""

from __future__ import annotations

import asyncio
import base64
import json
from typing import Any

import numpy as np
import torch

from gofr_tpu_torch.models import whisper
from gofr_tpu_torch.ops.audio import log_mel_spectrogram


class ASRWorker:
    def __init__(
        self,
        cfg: whisper.WhisperConfig,
        params: dict,
        tokenizer: Any = None,
        reply_topic: str = "asr-results",
        n_fft: int = 400,
        hop: int = 160,
    ) -> None:
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.reply_topic = reply_topic
        self.n_fft = n_fft
        self.hop = hop
        self.device = params["tok_embedding"].device

    def decode_audio(self, job: dict) -> np.ndarray:
        if "audio_b64" in job:
            raw = base64.b64decode(job["audio_b64"])
            return np.frombuffer(raw, np.float32)
        return np.asarray(job.get("audio", []), np.float32)

    def mel(self, audio: np.ndarray) -> torch.Tensor:
        """[1, n_frames, n_mels] log-mel features of one clip on the device."""
        samples = torch.from_numpy(np.array(audio[None, :], dtype=np.float32)).to(self.device)
        return log_mel_spectrogram(samples, n_fft=self.n_fft, hop=self.hop, n_mels=self.cfg.n_mels)

    def transcribe_job(self, job: dict) -> dict:
        audio = self.decode_audio(job)
        if audio.size == 0:
            return {"id": job.get("id"), "error": "empty audio"}
        ids = whisper.transcribe(self.cfg, self.params, self.mel(audio), job.get("max_tokens"))[0]
        text = self.tokenizer.decode(ids) if self.tokenizer is not None else None
        return {"id": job.get("id"), "token_ids": ids, "text": text}

    async def handler(self, ctx: Any) -> Any:
        """The subscription handler. Transcription runs in the executor so
        the event loop keeps serving; the result is published to the job's
        reply topic."""
        job = ctx.bind(dict)
        loop = asyncio.get_running_loop()
        result = await loop.run_in_executor(None, self.transcribe_job, job)
        publisher = ctx.get_publisher()
        if publisher is not None:
            topic = job.get("reply_topic", self.reply_topic)
            publisher.publish(topic, json.dumps(result).encode())
        return result
