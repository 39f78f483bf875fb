"""Autoregressive generation driver (counterpart of paddle_tpu/decode).

A model describes generation as TWO programs over one shared scope
(models/transformer.build_decode):

  * PREFILL — one batched pass over the prompt: encodes the source, seeds
    every decoder layer's KV cache with the prefix's k/v rows and emits the
    first next-token logits;
  * STEP — one token for the whole batch: appends the token's k/v into the
    preallocated [B, max_len, H*D] caches at per-row cursors and attends
    single-query over them.

GenerationSpec is the contract between the builders and this driver;
Generator owns the host loop (greedy argmax; beam search waits for the
`beam_search` op).  Each program runs as a replay of its ops
(framework.executor.program_as_function) on the Generator's place, under
torch.inference_mode().
"""

from __future__ import annotations

import numpy as np
import torch

from ..framework.core_types import as_device, dtype_to_torch
from ..framework.executor import Executor, program_as_function
from ..framework.scope import Scope

__all__ = ["StateSpec", "GenerationSpec", "Generator"]


class StateSpec:
    """One carried decode state.

    feed: the step program's feed name for this state;
    init_from: prefill fetch (var name) seeding it — None = zeros of shape
        [B, *zeros];
    update: step fetch (var name) producing the next step's value —
        None = constant across steps (encoder-side k/v);
    pad_to: pad axis 1 up to this length after prefill (prefix-seeded KV
        caches grow to the preallocated max_len buffer);
    verify_update / chunk_update: the same fetch in the Sq=k speculative
        verify and Sq=chunk chunked-prefill programs (None while the spec
        has none);
    encode_from: fetch in the encode program seeding this CONSTANT state
        when a chunked prompt never runs the prefill program.
    """

    def __init__(self, feed, init_from=None, update=None, pad_to=None,
                 zeros=None, dtype="float32", verify_update=None,
                 chunk_update=None, encode_from=None):
        self.feed = feed
        self.init_from = init_from
        self.update = update
        self.pad_to = pad_to
        self.zeros = zeros
        self.dtype = dtype
        self.verify_update = verify_update
        self.chunk_update = chunk_update
        self.encode_from = encode_from


class GenerationSpec:
    """The contract between a model's builders and the decode drivers
    (decode/__init__.py:72 of the JAX package): program pairs, feed and
    fetch names, and the StateSpecs.  The verify_*, chunk_* and encode_*
    program slots (speculative verify, chunked prefill, the encoder-only
    pass) and the monitor side-band have the JAX package's names."""

    def __init__(self, *, prefill_program, prefill_startup, step_program,
                 step_startup, prefill_feeds, step_feeds, step_logits,
                 states, prefill_logits=None, lengths_name=None,
                 init_lengths_from=None, max_len=None, bos_id=0, eos_id=1,
                 prev_ids_name="prev_ids", verify_program=None,
                 verify_startup=None, verify_logits=None, verify_len=None,
                 monitor_fetches=None, monitor=None, chunk_program=None,
                 chunk_startup=None, chunk_logits=None, chunk_len=None,
                 encode_program=None, encode_startup=None,
                 prompt_ids_name=None):
        self.prefill_program = prefill_program
        self.prefill_startup = prefill_startup
        self.step_program = step_program
        self.step_startup = step_startup
        self.prefill_feeds = list(prefill_feeds)
        self.prefill_logits = prefill_logits
        self.step_feeds = list(step_feeds)  # per-call constants (src_lens)
        self.step_logits = step_logits
        self.states = list(states)
        self.lengths_name = lengths_name  # step feed of the write cursors
        self.init_lengths_from = init_lengths_from  # prefill feed name
        self.max_len = max_len
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.prev_ids_name = prev_ids_name
        # Sq=k speculative-verify sibling of the step program
        self.verify_program = verify_program
        self.verify_startup = verify_startup
        self.verify_logits = verify_logits
        self.verify_len = verify_len
        # Sq=chunk chunked-prefill sibling
        self.chunk_program = chunk_program
        self.chunk_startup = chunk_startup
        self.chunk_logits = chunk_logits
        self.chunk_len = chunk_len
        # encoder-only program seeding the constant cross-attention k/v
        # states when chunking skips the prefill program
        self.encode_program = encode_program
        self.encode_startup = encode_startup
        # prefill feed holding the [B, prefix_len] prompt token ids
        self.prompt_ids_name = prompt_ids_name
        # observability side-band: extra step fetches handed to
        # `monitor(outs)` after every step
        self.monitor_fetches = list(monitor_fetches or [])
        self.monitor = monitor

    def prefill_fetches(self):
        names = [s.init_from for s in self.states if s.init_from]
        if self.prefill_logits:
            names.append(self.prefill_logits)
        return names

    def step_fetches(self):
        names = [self.step_logits] + [s.update for s in self.states
                                      if s.update]
        names += [n for n in self.monitor_fetches if n not in names]
        return names

    def notify_monitor(self, outs):
        """Feed one step's fetched outputs to the monitor callback (a
        no-op without one).  A monitor failure never takes down the decode
        loop: it is observability, not correctness."""
        if self.monitor is None:
            return
        try:
            self.monitor(outs)
        except Exception:  # noqa: BLE001
            pass

    def verify_fetches(self):
        return [self.verify_logits] + [s.verify_update for s in self.states
                                       if s.verify_update]

    def chunk_fetches(self):
        return [self.chunk_logits] + [s.chunk_update for s in self.states
                                      if s.chunk_update]

    def encode_fetches(self):
        return [s.encode_from for s in self.states if s.encode_from]


class Generator:
    """Runs a GenerationSpec against a scope on a place (the card unless
    the caller passes `CPUPlace()`).  Parameters the scope already holds
    are never touched — only missing vars (the decode programs' position
    tables, or every weight when generating from scratch) are initialized
    from the startup programs."""

    def __init__(self, spec: GenerationSpec, scope=None, place=None):
        self.spec = spec
        self.scope = scope if scope is not None else Scope()
        self.device = as_device(place)
        self._fns = {}  # program tag -> replay function
        self._ensure_vars()

    def _ensure_vars(self):
        """Run every startup program of the spec (prefill, step, verify,
        chunk, encode) in a THROWAWAY scope and copy over only vars the
        real scope lacks."""
        exe = Executor(self.device)
        spec = self.spec
        for startup in (spec.prefill_startup, spec.step_startup,
                        spec.verify_startup, spec.chunk_startup,
                        spec.encode_startup):
            if startup is None or not startup.global_block().ops:
                continue
            tmp = Scope()
            exe.run(startup, scope=tmp)
            for n in tmp.local_var_names():
                if self.scope.find_var(n) is None:
                    self.scope.set_var(n, tmp.find_var(n))

    def _run(self, tag, program, fetch_names, feed):
        """Replay `program` with `feed` (name -> array or tensor) over the
        scope; returns {fetch_name: tensor}.  One replay function per tag
        ("prefill", "step", "encode")."""
        fn = self._fns.get(tag)
        if fn is None:
            fn = program_as_function(program, self.scope, fetch_names,
                                     self.device)
            self._fns[tag] = fn
        return dict(zip(fetch_names, fn(feed)))

    @torch.inference_mode()
    def _prefill(self, feed):
        spec = self.spec
        pf = {n: np.asarray(feed[n]) for n in spec.prefill_feeds}
        batch = next(iter(pf.values())).shape[0]
        outs = self._run("prefill", spec.prefill_program,
                         spec.prefill_fetches(), pf)
        states = {}
        for s in spec.states:
            if s.init_from:
                v = outs[s.init_from]
                if s.pad_to is not None and v.shape[1] < s.pad_to:
                    pad = [0, 0] * (v.dim() - 2) + [0, s.pad_to - v.shape[1]]
                    v = torch.nn.functional.pad(v, pad)
            else:
                v = torch.zeros((batch,) + tuple(s.zeros or ()),
                                dtype=dtype_to_torch(s.dtype),
                                device=self.device)
            states[s.feed] = v
        if spec.init_lengths_from is not None:
            lengths = np.asarray(feed[spec.init_lengths_from],
                                 np.int64).reshape(batch).copy()
        else:
            lengths = np.zeros(batch, np.int64)
        logits = outs.get(spec.prefill_logits) if spec.prefill_logits \
            else None
        return batch, states, lengths, logits

    @torch.inference_mode()
    def _step(self, prev_tok, lengths, states, feed):
        """One decode step: returns (logits [B, V], updated states)."""
        spec = self.spec
        sf = {spec.prev_ids_name: np.asarray(prev_tok,
                                             np.int64).reshape(-1, 1)}
        if spec.lengths_name is not None:
            sf[spec.lengths_name] = np.asarray(lengths, np.int64)
        for n in spec.step_feeds:
            sf[n] = np.asarray(feed[n])
        sf.update(states)
        outs = self._run("step", spec.step_program, spec.step_fetches(), sf)
        spec.notify_monitor(outs)
        for s in spec.states:
            if s.update:
                states[s.feed] = outs[s.update]
        return outs[spec.step_logits], states

    def _room(self, lengths):
        return (self.spec.max_len is None
                or int(np.max(lengths)) < self.spec.max_len)

    def generate(self, feed, max_new_tokens, method="greedy", bos_id=None,
                 eos_id=None):
        """feed: {prefill feed name: array} (+ any step_feeds constants).
        Returns int64 tokens [B, T] (rows padded with eos after their eos),
        T <= max_new_tokens, bounded further by the cache's max_len."""
        if method != "greedy":
            raise NotImplementedError(
                f"generation method {method!r}: the port has greedy only; "
                "beam search waits for the beam_search op (ROADMAP A)")
        bos = self.spec.bos_id if bos_id is None else bos_id
        eos = self.spec.eos_id if eos_id is None else eos_id
        batch, states, lengths, logits = self._prefill(feed)
        out = []
        finished = np.zeros(batch, bool)
        if logits is not None:
            tok = _argmax(logits, batch)
            out.append(tok)
            finished |= tok == eos
        else:
            tok = np.full(batch, bos, np.int64)
        while len(out) < max_new_tokens and not finished.all() \
                and self._room(lengths):
            logits, states = self._step(tok, lengths, states, feed)
            lengths += 1
            tok = np.where(finished, eos, _argmax(logits, batch))
            out.append(tok)
            finished |= tok == eos
        if not out:
            return np.zeros((batch, 0), np.int64)
        return np.stack(out, axis=1)


def _argmax(logits, batch):
    return torch.argmax(logits, dim=-1).cpu().numpy().astype(
        np.int64).reshape(batch)
