"""Batched serving engine over the decoder zoo's prefill and decode steps
(port of ``repro.serving.engine``): KV caches, MLA's latent cache and
Mamba2's conv and SSM states alike.

Static-batch serving: requests queue up, the engine assembles a batch
(left-padding prompts with token 0 to a common length, with no padding
mask, as the reference: a Mamba state absorbs the pads as the
reference's does), prefills once, then decodes token by token until
every sequence hits its max_new_tokens or emits EOS. It serves the server
model of a federated run: inference of the federated result.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (decode_step, forward,
                                      frontend_refusal, init_cache)


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    eos_id: int = -1            # -1: never stop early
    out_tokens: List[int] = field(default_factory=list)


class ServeEngine:
    """Serves requests against ``params`` (a flat dict of tensors; the
    engine runs on their device). Requests are token prompts: an
    encoder-decoder or frontend model is refused."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 8,
                 max_seq: int = 256, temperature: float = 0.0):
        why = frontend_refusal(cfg, "ServeEngine")
        if why:
            raise NotImplementedError(why)
        self.cfg = cfg
        self.params = params
        self.device = params["embed/tok"].device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.temperature = temperature
        self.queue: List[Request] = []

    @classmethod
    def from_algorithm(cls, cfg: ModelConfig, alg, state, **kw):
        """Serve the server model of any federated run: ``alg`` is an
        algorithm of :mod:`repro_torch.fed.registry` and ``state`` its
        final state; ``eval_params`` is the protocol's one door to the
        trained model."""
        return cls(cfg, alg.eval_params(state), **kw)

    def submit(self, req: Request):
        self.queue.append(req)

    def _prefill(self, prompts: torch.Tensor):
        """(last-position fp32 logits (b, V), cache) of a padded batch."""
        cache = init_cache(self.cfg, prompts.shape[0], self.max_seq,
                           self.device)
        logits, cache, _ = forward(self.cfg, self.params,
                                   {"tokens": prompts}, cache=cache,
                                   write_pos=0)
        # a copy, so the (b, t, V) logits are freed here
        return logits[:, -1].clone(), cache

    def _decode(self, tok: torch.Tensor, pos: int, cache):
        """(fp32 logits (b, V) of the next position, cache)."""
        logits, cache = decode_step(self.cfg, self.params, tok[:, None], pos,
                                    cache)
        return logits[:, -1], cache

    def _sample(self, logits: torch.Tensor, generator):
        """Greedy argmax, or at temperature > 0 a categorical draw
        (Gumbel-max, uniforms from ``generator``)."""
        if self.temperature > 0:
            u = torch.rand(logits.shape, generator=generator,
                           device=generator.device).to(logits.device)
            return torch.argmax(logits / self.temperature
                                - torch.log(-torch.log(u)), dim=-1)
        return torch.argmax(logits, dim=-1)

    def run(self, generator: Optional[torch.Generator] = None,
            on_step: Optional[Callable[[int, torch.Tensor], None]] = None
            ) -> List[Request]:
        """Serve everything in the queue; returns completed requests.
        Sampling draws from ``generator`` (one seeded 0 on the engine's
        device when None). ``on_step(step, logits)``, when given, is called
        after each prefill (step 0) and decode step of a batch, once the
        step's tokens are back on the host, with the (b, V) fp32 logits they
        were drawn from."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        done: List[Request] = []
        while self.queue:
            batch = self.queue[: self.max_batch]
            self.queue = self.queue[self.max_batch:]
            plen = max(len(r.prompt) for r in batch)
            prompts = torch.zeros((len(batch), plen), dtype=torch.int64)
            for i, r in enumerate(batch):
                prompts[i, plen - len(r.prompt):] = torch.tensor(
                    r.prompt, dtype=torch.int64)  # left-pad with 0
            last_logits, cache = self._prefill(prompts.to(self.device))
            tok = self._sample(last_logits, generator)
            alive = [True] * len(batch)
            steps = max(r.max_new_tokens for r in batch)
            for r, t in zip(batch, tok.tolist()):
                r.out_tokens.append(t)
            if on_step is not None:
                on_step(0, last_logits)
            pos = plen
            for _ in range(min(steps - 1, self.max_seq - plen - 1)):
                logits, cache = self._decode(tok, pos, cache)
                tok = self._sample(logits, generator)
                pos += 1
                for i, (r, t) in enumerate(zip(batch, tok.tolist())):
                    if not alive[i]:
                        continue
                    if len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(t)
                    if t == r.eos_id or len(r.out_tokens) >= r.max_new_tokens:
                        alive[i] = False
                if on_step is not None:
                    on_step(pos - plen, logits)
                if not any(alive):
                    break
            done.extend(batch)
        return done
