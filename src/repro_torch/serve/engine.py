"""Batched serving engine: wave batching with ragged prompts.

Requests are grouped into fixed-size waves (sorted by prompt length); within
a wave prompts are right-padded, prefilled once (per-sequence last-position
logits), then decoded with **per-sequence positions** (vector ``pos``) so
each stream advances from its own true length.  Finished sequences (stop
token or length) are masked out; the wave ends when all finish.

Greedy or temperature sampling; deterministic per seed (an explicit
:class:`torch.Generator`).  The engine runs on the card unless it is given
``device="cpu"``, and records each wave's ``prefill`` and ``decode`` spans in
an :class:`~repro_torch.core.telemetry.EventCollector`, which
:meth:`ServeEngine.mine_telemetry` mines through the query engine on the
same device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.telemetry import EventCollector
from ..device import resolve_device
from ..models import decode_step, prefill
from ..models.model import DecoderLM, serving_weights

__all__ = ["ServeEngine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    prompt: List[int]
    tokens: List[int]
    finished: str  # "stop" | "length"


class ServeEngine:
    """``params`` is the port's :class:`~repro_torch.models.model.DecoderLM`.
    The engine moves it to ``device`` and casts its matrices to
    ``cfg.dtype`` **in place**, once
    (:func:`~repro_torch.models.model.serving_weights`): every use casts
    them there anyway, so the model's outputs do not change, and the card
    reads half the bytes per decode step."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: DecoderLM,
        *,
        max_batch: int = 8,
        max_cache: int = 512,
        q_chunk: int = 64,
        temperature: float = 0.0,
        seed: int = 0,
        collector: Optional[EventCollector] = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = serving_weights(cfg, params.to(self.device))
        self.max_batch = max_batch
        self.max_cache = max_cache
        self.q_chunk = q_chunk
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # explicit None check: an empty collector is falsy (len == 0).
        # The default is ring-buffered: a long-lived server keeps the most
        # recent 64Ki spans for forensics instead of growing without bound
        # (drops are counted — see EventCollector.dropped).
        self.collector = (
            collector
            if collector is not None
            else EventCollector("server", max_events=1 << 16)
        )
        self._query_engine = None

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    def generate(
        self,
        prompts: List[List[int]],
        max_new_tokens: int = 32,
        stop_token: Optional[int] = None,
    ) -> List[GenerationResult]:
        results: List[Optional[GenerationResult]] = [None] * len(prompts)
        order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
        for w0 in range(0, len(order), self.max_batch):
            wave = order[w0 : w0 + self.max_batch]
            self._run_wave(wave, prompts, results, max_new_tokens, stop_token)
        return [r for r in results if r is not None]

    def mine_telemetry(self, time_window=None):
        """Mine the engine's own runtime telemetry (wave/prefill/decode
        spans) through the process-query engine.

        Returns the :class:`repro_torch.query.QueryResult` for the DFG of
        the serving process — the fault/straggler forensics view.  Each wave
        is one trace; a healthy engine's DFG is ``prefill → decode^k``.  It
        runs on the engine's device: the default query engine on the card,
        or a CPU :class:`~repro_torch.query.QueryEngine` kept by this engine
        when it serves on the host."""
        from ..query import Q

        q = Q.log(self.collector.to_repository()).using(self._mining_engine())
        if time_window is not None:
            q = q.window(*time_window)
        return q.dfg()

    def _mining_engine(self):
        from ..query import QueryEngine, default_engine

        if self.device.type == "cpu":
            if self._query_engine is None:
                self._query_engine = QueryEngine(device="cpu")
            return self._query_engine
        engine = default_engine()
        if engine.device.type != self.device.type:
            raise RuntimeError(
                f"the default query engine runs on {engine.device}, the "
                f"serving engine on {self.device}: telemetry is mined on the "
                "serving engine's device"
            )
        return engine

    def _sync(self) -> None:
        """End a span when the card has finished its work, so a span's
        duration is the step's and not its enqueue's (the next sample reads
        the logits back and would wait there anyway)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_wave(self, wave, prompts, results, max_new, stop_token):
        B = len(wave)
        dev = self.device
        lens = np.asarray([len(prompts[i]) for i in wave], dtype=np.int64)
        L = int(lens.max())
        toks = np.zeros((B, L), dtype=np.int64)
        for r, i in enumerate(wave):
            toks[r, : lens[r]] = prompts[i]
        case = f"wave-{wave[0]}"
        with self.collector.span(case, "prefill"):
            caches, logits = prefill(
                self.cfg, self.params,
                {"tokens": torch.from_numpy(toks).to(dev)},
                self.max_cache, q_chunk=self.q_chunk,
                last_index=torch.from_numpy(lens - 1).to(dev),
            )
            self._sync()
        pos = lens.copy()  # next write slot per sequence
        out = [[] for _ in range(B)]
        done = np.zeros(B, dtype=bool)
        finished = ["length"] * B
        for t in range(max_new):
            nxt = self._sample(logits)
            nxt_np = nxt.cpu().numpy()
            for r in range(B):
                if not done[r]:
                    tok = int(nxt_np[r])
                    if stop_token is not None and tok == stop_token:
                        done[r] = True
                        finished[r] = "stop"
                    else:
                        out[r].append(tok)
            if done.all() or t == max_new - 1:
                break
            with self.collector.span(case, "decode"):
                logits, caches = decode_step(
                    self.cfg, self.params, nxt[:, None], caches,
                    torch.from_numpy(pos).to(dev),
                )
                self._sync()
            pos = pos + 1
            if int(pos.max()) >= self.max_cache:
                break
        for r, i in enumerate(wave):
            results[i] = GenerationResult(
                prompt=list(prompts[i]), tokens=out[r], finished=finished[r]
            )
