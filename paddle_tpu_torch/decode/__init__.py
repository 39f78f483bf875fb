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
Generator owns the host loop: greedy argmax, or beam search driven by the
per-step `beam_search` op with the caches reordered on beam hops by one
gather (kv_cache.gather_beams).  Each program runs through
framework.executor.program_as_function on the Generator's place, under
torch.inference_mode(), one function per (tag, feed shapes and dtypes,
flags.trace_signature()) as in the JAX package: on the card a step is
captured as a CUDA graph at its second call and replayed after.  So that
the graph reads the caches where they lie, the decode states live in the
Generator's own buffers (one per name, shape and dtype), which every
prefill refills in place.
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

    def __init__(self, spec: GenerationSpec, scope=None, place=None,
                 mode="jit"):
        self.spec = spec
        self.scope = scope if scope is not None else Scope()
        self.device = as_device(place)
        # "jit": programs captured as CUDA graphs on the card; "interpret":
        # their ops replayed eagerly at every call
        self.mode = mode
        # (tag, feed shapes and dtypes, trace signature) -> replay function
        self._fns = {}
        self._slots = {}   # (state, shape, dtype) -> the state's buffer
        self._pool = None
        self._ensure_vars()

    def graph_pool(self):
        """The memory pool every CUDA graph of this Generator (and of a
        Scheduler over it) allocates from: one pool, safe because replays
        are serial on one stream and each graph's outputs are copied out
        of it, or are the caller's own tensors written in place, before
        another graph replays.  None on the CPU."""
        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

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
        scope; returns {fetch_name: tensor}.  One function per (tag, feed
        shapes and dtypes, flags.trace_signature()), the JAX package's key
        (decode/__init__.py:223-236)."""
        from .. import flags

        sig = tuple((n, tuple(v.shape), str(v.dtype))
                    for n, v in sorted(feed.items()))
        key = (tag, sig, flags.trace_signature())
        fn = self._fns.get(key)
        if fn is None:
            fn = program_as_function(program, self.scope, fetch_names,
                                     self.device,
                                     graph_pool=self.graph_pool(),
                                     mode=self.mode)
            self._fns[key] = fn
        return dict(zip(fetch_names, fn(feed)))

    def _slot(self, name, shape, dtype):
        key = (name, tuple(shape), dtype)
        buf = self._slots.get(key)
        if buf is None:
            buf = self._slots[key] = torch.empty(shape, dtype=dtype,
                                                 device=self.device)
        return buf

    @torch.inference_mode()
    def _prefill(self, feed, slots=True):
        """Run the prefill program; returns (batch, states, lengths,
        logits).  With `slots` the states are the Generator's own buffers,
        refilled in place (an earlier prefill's states are overwritten);
        without, fresh tensors (the Scheduler copies rows out of them)."""
        spec = self.spec
        pf = {n: np.asarray(feed[n]) for n in spec.prefill_feeds}
        batch = next(iter(pf.values())).shape[0]
        outs = self._run("prefill", spec.prefill_program,
                         spec.prefill_fetches(), pf)
        states = {}
        for s in spec.states:
            if s.init_from:
                v = outs[s.init_from]
                rows = v.shape[1]
                shape = (v.shape[0], max(rows, s.pad_to or 0)) \
                    + tuple(v.shape[2:])
            else:
                v, rows = None, 0
                shape = (batch,) + tuple(s.zeros or ())
            dtype = v.dtype if v is not None else dtype_to_torch(s.dtype)
            if slots:
                buf = self._slot(s.feed, shape, dtype)
            elif v is not None and shape == tuple(v.shape):
                states[s.feed] = v
                continue
            else:
                buf = torch.empty(shape, dtype=dtype, device=self.device)
            if v is not None:
                buf[:, :rows].copy_(v)
                buf[:, rows:].zero_()
            else:
                buf.zero_()
            states[s.feed] = buf
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

    def generate(self, feed, max_new_tokens, method="greedy", beam_size=4,
                 bos_id=None, eos_id=None):
        """feed: {prefill feed name: array} (+ any step_feeds constants).

        greedy -> int64 tokens [B, T] (rows padded with eos after their
        eos); beam -> (tokens [B, K, T], scores [B, K]), best beam first.
        T <= max_new_tokens, bounded further by the cache's max_len."""
        bos = self.spec.bos_id if bos_id is None else bos_id
        eos = self.spec.eos_id if eos_id is None else eos_id
        if method == "greedy":
            return self._greedy(feed, max_new_tokens, bos, eos)
        if method == "beam":
            return self._beam(feed, max_new_tokens, int(beam_size), bos, eos)
        raise ValueError(f"unknown generation method {method!r}")

    def _greedy(self, feed, max_new_tokens, bos, eos):
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

    @torch.inference_mode()
    def _beam(self, feed, max_new_tokens, k, bos, eos):
        """Beam search (decode/__init__.py:_beam of the JAX package): the
        prefill's logits fan out to the top k of their log_softmax (or all
        beams start at bos with only beam 0 alive), each step scores the
        top k of every beam's log_softmax and the `beam_search` op picks
        the survivors, tokens, caches and cursors hop to their parent
        beams, and the search stops when every beam has finished.  The
        step runs at batch * k rows, over states tiled into the
        Generator's buffers and reordered in place, so a captured step
        keeps reading them where they lie."""
        from ..ops import kv_cache, registry
        from ..ops.beam_search_ops import top_k

        spec = self.spec
        batch, states, lengths, logits = self._prefill(feed, slots=False)
        tiled = {}
        for name, v in states.items():
            buf = self._slot(name, (batch * k,) + tuple(v.shape[1:]),
                             v.dtype)
            buf.view((batch, k) + tuple(v.shape[1:])).copy_(
                v[:, None].expand((batch, k) + tuple(v.shape[1:])))
            tiled[name] = buf
        states = tiled
        lengths = np.repeat(lengths, k, axis=0)
        tiled_feed = dict(feed)
        for n in spec.step_feeds:
            tiled_feed[n] = np.repeat(np.asarray(feed[n]), k, axis=0)
        info = registry.get_op_info("beam_search")
        if logits is not None:
            top_scores, top_ids = top_k(
                torch.log_softmax(logits.float(), dim=-1), k)
            pre_ids = top_ids.cpu().numpy().astype(np.int64)     # [B, K]
            pre_scores = top_scores.cpu().numpy().astype(np.float32)
            tokens = pre_ids[..., None]
        else:
            pre_ids = np.full((batch, k), bos, np.int64)
            pre_scores = np.concatenate(
                [np.zeros((batch, 1), np.float32),
                 np.full((batch, k - 1), -1e30, np.float32)], axis=1)
            tokens = np.zeros((batch, k, 0), np.int64)
        while tokens.shape[-1] < max_new_tokens and self._room(lengths):
            if np.all(pre_ids == eos):
                break   # every beam finished, the prefill's eos included
            logits, states = self._step(pre_ids.reshape(-1), lengths,
                                        states, tiled_feed)
            lengths += 1
            cand_scores, cand_ids = top_k(
                torch.log_softmax(logits.float(), dim=-1), k)  # [B*K, K]
            dev = cand_scores.device
            cand_scores = (cand_scores.reshape(batch, k, k)
                           + torch.as_tensor(pre_scores, device=dev)[..., None])
            outs = registry.run_forward(
                info,
                {"pre_ids": [torch.as_tensor(pre_ids, device=dev)],
                 "pre_scores": [torch.as_tensor(pre_scores, device=dev)],
                 "ids": [cand_ids.reshape(batch, k, k)],
                 "scores": [cand_scores]},
                {"beam_size": k, "end_id": int(eos)})
            sel_ids = outs["selected_ids"][0].cpu().numpy().astype(np.int64)
            sel_scores = outs["selected_scores"][0].cpu().numpy().astype(
                np.float32)
            parent_t = outs["parent_idx"][0]
            parent = parent_t.cpu().numpy().astype(np.int64)
            # the beam hop: histories, caches and cursors follow their
            # parent beams
            tokens = np.concatenate(
                [np.take_along_axis(tokens, parent[..., None], axis=1),
                 sel_ids[..., None]], axis=-1)
            for s in spec.states:
                if s.update:
                    st = states[s.feed]
                    st.copy_(kv_cache.gather_beams(st, parent_t, batch, k))
            lengths = np.take_along_axis(
                lengths.reshape(batch, k), parent, axis=1).reshape(-1)
            pre_ids, pre_scores = sel_ids, sel_scores
        order = np.argsort(-pre_scores, axis=1)
        tokens = np.take_along_axis(tokens, order[..., None], axis=1)
        scores = np.take_along_axis(pre_scores, order, axis=1)
        return tokens, scores


def _argmax(logits, batch):
    return torch.argmax(logits, dim=-1).cpu().numpy().astype(
        np.int64).reshape(batch)
