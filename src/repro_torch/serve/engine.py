"""Serving engines: the fixed-slot batch and the continuous-batching tier
(counterpart of ``repro.serve.engine``, chip scope).

:class:`Engine` runs one batched request: a prefill over the padded batch
(behind the frontend embeddings of a VLM or audio config), then one decode
step per token against a fixed-size cache (K/V, the SSM family's recurrent
states, or both for the hybrid family), with an EOS check lagged by a
window so the host does not wait on every step.

:class:`ContinuousEngine` (DESIGN.md §13) serves a stream of requests over
a paged KV cache (``serve/kvcache.py``; the dense and MoE families only,
as in the JAX package: the SSM, hybrid, VLM and audio ones raise):
host-side admission and page accounting (``serve/scheduler.py``), one
prefill chunk per iteration interleaved with one batched decode step over
the active slots, and a lagged demux of the emitted tokens.  Slot
recycling rewrites the *contents* of the device-side table/lens/active
buffers, never their shapes or storage, so the decode step sees the same
input tensors for the
life of the engine (what a captured CUDA graph needs; the JAX engine's
single jit cache entry plays that part there).

Observability (DESIGN.md §14), as in the JAX engine: the loop records
the spans ``serve.admit``, ``serve.prefill_chunk``, ``serve.decode`` and
``serve.demux`` while the tracer is on (:mod:`repro_torch.obs.trace`; a
span times the host's enqueue, never a device wait), always counts
``serve.tokens``, ``serve.ttft_s``, ``serve.token_latency_s`` and
``serve.occupancy_dist``, keeps ``serve.idle_s`` at 0 (every request is
submitted at once, so the loop never waits on an arrival)
(:mod:`repro_torch.obs.metrics`; the scheduler adds its own), and posts
one heartbeat per loop iteration with the decoding occupancy to a
:class:`~repro_torch.runtime.fault_tolerance.HeartbeatStore`.

Execution levels (DESIGN.md §10, §13), as in the JAX engines: each engine
pins ``execlevel.current()`` at construction, as it pins the plane.  The
fixed engine's prefill runs under the pinned level, so at O3/O4 a prompt
the ring divides takes ring attention
(:mod:`repro_torch.distributed.attention`); its decode runs outside the
level.  The continuous engine stripes its page pool over the pinned mesh's
ring (each rank allocates its ``P / W`` pages; the table and lens stay
whole on every rank) and serves under the pinned level, so decode takes
``paged_attention``/``ring``.  Every rank of the world runs the same
engine on the same requests; the collectives leave the same bits on every
rank, so the ranks' host loops stay in step.

On a pinned mesh whose ``model`` axis is wider than 1 the fixed engine's
prefill and decode run split over it (``distributed.model_split``): each
rank runs its heads, vocabulary columns and experts of the whole
parameters it was handed (views, nothing copied), its cache holds its kv
heads, and the logits are gathered whole before sampling, so every rank
emits the same tokens.  The continuous engine's pool split by heads is
ROADMAP queue 1 item 10b-iii-b: it raises on such a mesh.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import execlevel, registry
from repro_torch.distributed import model_split
from repro_torch.distributed.collectives import ambient_ring_plan
from repro_torch.kernels.flash_attention import NEG_INF
from repro_torch.models.lm import LM
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.fault_tolerance import HeartbeatStore
from repro_torch.serve.kvcache import init_cache_state, make_spec
from repro_torch.serve.scheduler import Request, Scheduler

Params = dict[str, Any]

__all__ = ["SamplingParams", "Engine", "ContinuousEngine", "ServeStats",
           "sample_token"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0              # 0 = no top-k
    greedy: bool = False
    #: What early-stopped slots pad with when no ``eos_id`` is given.
    pad_id: int = 0


def sample_token(gen: Optional[torch.Generator], logits: torch.Tensor,
                 sp: SamplingParams) -> torch.Tensor:
    """logits (B, V) -> tokens (B,) int32; ``gen`` draws the samples (on
    the logits' device; unused when greedy)."""
    if sp.greedy:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / max(sp.temperature, 1e-6)
    if sp.top_k:
        kth = torch.topk(logits, sp.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


class Engine:
    """Fixed-slot batched generation: prefill, then a host-driven decode
    loop against the fixed-size cache."""

    #: decode steps between host-side all-done checks; finished slots emit
    #: eos in between, so a coarser period costs only a few extra steps.
    EOS_CHECK_EVERY = 8

    def __init__(self, lm: LM, params: Params, *, max_len: int = 2048,
                 sampling: SamplingParams = SamplingParams(greedy=True)):
        self.lm = lm
        self.params = params
        self.max_len = max_len
        self.sampling = sampling
        # the plane requested when the engine was built, kept for every call
        self.active_backend = registry.requested_backend()
        # the level and mesh too: prefill re-enters them on every call, so
        # at O3/O4 a prompt the ring divides takes ring attention; decode
        # (one token against the resident cache) runs outside them; both
        # run split over the mesh's model axis
        self.active_level = execlevel.current()
        self.split = model_split.split_of(self.active_level.mesh,
                                          held=False) \
            if self.active_level.level >= execlevel.ExecLevel.O3 else None

    def generate(self, tokens: torch.Tensor, *, max_new_tokens: int = 32,
                 eos_id: Optional[int] = None, seed: int = 0,
                 frontend_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """tokens (B, S) prompt on the params' device -> (B, max_new_tokens)
        generated ids (int32).  A VLM or audio config takes
        ``frontend_embeds`` (B, frontend_len, d_model) ahead of the prompt.
        Raises ValueError, before any work, when the frontend, the prompt
        and the new tokens do not fit ``max_len`` cache slots (a config
        with a K/V cache)."""
        cfg = self.lm.cfg
        front = cfg.frontend_len if cfg.frontend is not None else 0
        need = front + tokens.shape[1] + max_new_tokens
        if cfg.has_attention and need > self.max_len:
            raise ValueError(
                f"{cfg.name}: {front} frontend + {tokens.shape[1]} prompt + "
                f"{max_new_tokens} new positions exceed the engine's max_len "
                f"{self.max_len}")
        with model_split.splitting(self.split):
            if self.active_backend is None:
                return self._generate(tokens, max_new_tokens, eos_id, seed,
                                      frontend_embeds)
            with registry.use_backend(self.active_backend):
                return self._generate(tokens, max_new_tokens, eos_id, seed,
                                      frontend_embeds)

    def _generate(self, tokens, max_new_tokens, eos_id, seed,
                  frontend_embeds):
        B = tokens.shape[0]
        lvl = self.active_level
        with execlevel.use_level(lvl.level, lvl.mesh):
            logits, cache = self.lm.prefill(self.params, tokens,
                                            frontend_embeds,
                                            max_len=self.max_len)
        gen = _generator(logits.device, seed)
        nxt = sample_token(gen, logits, self.sampling)
        outs = [nxt]
        done = torch.zeros((B,), dtype=torch.bool, device=nxt.device)
        if eos_id is not None:
            done = nxt == eos_id
        # the boundary check reads the done flags of the previous window,
        # whose steps finished a window ago: the host never waits on a step
        pending_done = None
        for step in range(max_new_tokens - 1):
            if eos_id is not None and \
                    step % self.EOS_CHECK_EVERY == self.EOS_CHECK_EVERY - 1:
                if pending_done is not None and bool(pending_done.all()):
                    break
                pending_done = done
            logits, cache = self.lm.decode_step(self.params, cache,
                                                nxt[:, None])
            nxt = sample_token(gen, logits, self.sampling)
            if eos_id is not None:
                nxt = torch.where(done, eos_id, nxt)     # freeze finished
                done = done | (nxt == eos_id)
            outs.append(nxt)
        out = torch.stack(outs, dim=1)
        if out.shape[1] < max_new_tokens:               # early stop: pad
            pad = eos_id if eos_id is not None else self.sampling.pad_id
            out = torch.cat([out, torch.full(
                (B, max_new_tokens - out.shape[1]), pad, dtype=torch.int32,
                device=out.device)], dim=1)
        return out


@dataclasses.dataclass
class ServeStats:
    """Per-iteration telemetry from :meth:`ContinuousEngine.serve` (host
    clock; the demux is lagged, so first-token times include up to one
    window of lag)."""
    iter_times: list        # wall seconds per loop iteration
    tokens_per_iter: list   # tokens emitted (decode + prefill completions)
    occupancy: list         # active-slot fraction per iteration
    token_latencies: list   # per emitted token: its iteration's wall time
    first_token_times: list  # per request: submit -> first token seconds


class ContinuousEngine:
    """Continuous batching over a paged KV cache.

    Per host-loop iteration: admission from the queue, one prefill chunk
    for the oldest prefilling slot, one batched decode step over the
    active slots, and every ``EOS_CHECK_EVERY`` iterations the demux of
    the *previous* window's device tokens.  ``decode_inputs`` records the
    (shape, storage) signature of every decode step's inputs; admissions
    and recycles leave it a single entry.  ``ring`` is the width the pool
    is striped over (1 on one card).  ``heartbeats`` (default: an
    in-process :class:`HeartbeatStore`) receives one beat per iteration as
    ``worker``."""

    EOS_CHECK_EVERY = 8

    def __init__(self, lm: LM, params: Params, *, num_slots: int = 8,
                 max_len: int = 2048, chunk_size: int = 32,
                 sampling: SamplingParams = SamplingParams(greedy=True),
                 heartbeats=None, worker: int = 0):
        # paged serving takes the dense and MoE families: the SSM and
        # hybrid ones carry recurrent state (ValueError, as in the JAX
        # package, which raises on its first chunk)
        lm._check_paged()
        # liveness: one beat per host-loop iteration carrying (step,
        # occupancy), the protocol the trainer posts to
        self.heartbeats = heartbeats if heartbeats is not None \
            else HeartbeatStore()
        self.worker = worker
        self.lm = lm
        self.params = params
        self.sampling = sampling
        self.chunk_size = chunk_size
        self.active_backend = registry.requested_backend()
        self.active_level = execlevel.current()
        if self.active_level.level >= execlevel.ExecLevel.O3 and \
                model_split.split_of(self.active_level.mesh,
                                     held=False) is not None:
            raise NotImplementedError(
                "ContinuousEngine on a mesh whose model axis is wider than 1: "
                "its page pool split by heads is not ported yet (ROADMAP "
                "queue 1 item 10b-iii-b); serve there with the fixed Engine")
        with execlevel.use_level(self.active_level.level,
                                 self.active_level.mesh):
            plan = ambient_ring_plan()
        self.ring = plan.size if plan is not None else 1
        cfg = lm.cfg
        self.device = params["embed"].device
        self.spec = make_spec(cfg, num_slots=num_slots, max_tokens=max_len,
                              ring=self.ring)
        # this rank's P / W pages of the pool; the table and lens whole
        self.state = init_cache_state(cfg, self.spec, device=self.device)
        self.sched = Scheduler(self.spec, cfg.serve_queue_depth)
        self._active = torch.zeros((num_slots,), dtype=torch.int32,
                                   device=self.device)
        self.decode_inputs: set = set()

    # -- the serve loop -----------------------------------------------------

    def serve(self, requests: Sequence[tuple], *,
              eos_id: Optional[int] = None, seed: int = 0,
              collect_stats: bool = False):
        """Run ``requests`` (a sequence of ``(prompt, max_new)`` pairs,
        all submitted at once) to completion.  Returns per-request
        generated token arrays (trimmed at the first eos), or
        ``(outputs, ServeStats)``."""
        reqs = [Request(rid=i, prompt=np.asarray(p, np.int32).reshape(-1),
                        max_new=int(m)) for i, (p, m) in enumerate(requests)]
        lvl = self.active_level
        with execlevel.use_level(lvl.level, lvl.mesh):
            if self.active_backend is None:
                return self._serve(reqs, eos_id, seed, collect_stats)
            with registry.use_backend(self.active_backend):
                return self._serve(reqs, eos_id, seed, collect_stats)

    def _upload_tables(self) -> None:
        """Copy the scheduler's table/lens into the same device buffers."""
        self.state["table"].copy_(torch.from_numpy(self.sched.table))
        self.state["lens"].copy_(torch.from_numpy(self.sched.lens))

    def _decode(self, cur: torch.Tensor, gen) -> torch.Tensor:
        bufs = (self.state["table"], self.state["lens"], self._active)
        self.decode_inputs.add(tuple((tuple(t.shape), t.data_ptr())
                                     for t in bufs) + (tuple(cur.shape),))
        logits, self.state = self.lm.decode_step_paged(
            self.params, self.state, cur[:, None], self._active)
        nxt = sample_token(gen, logits, self.sampling)
        # frozen slots pass their token through: their logits are garbage
        return torch.where(self._active > 0, nxt, cur)

    def _serve(self, reqs, eos_id, seed, collect_stats):
        sched, spec = self.sched, self.spec
        B = spec.num_slots
        C = self.chunk_size
        gen = _generator(self.device, seed)
        cur = torch.zeros((B,), dtype=torch.int32, device=self.device)

        outputs = {r.rid: [] for r in reqs}
        stats = ServeStats([], [], [], [], [])
        metrics = obs_metrics.METRICS
        # host mirrors advanced in lockstep with the device
        active_np = np.zeros((B,), np.int32)
        budget = np.zeros((B,), np.int64)
        gen_of = np.zeros((B,), np.int64)         # per-slot admission epoch
        live: dict[tuple, Any] = {}               # (slot, epoch) -> Request
        prefilling: list = []                     # slots in PREFILL, FIFO
        # lagged demux: device refs batch into windows; a boundary reads
        # the previous window, whose device work finished a window ago
        pending_old: list = []
        pending_cur: list = []

        to_submit = list(reqs)
        # every request is submitted at once, so the loop never waits on
        # an arrival: the reference's idle counter stays at 0
        metrics.counter("serve.idle_s")

        def set_active(slot, on):
            active_np[slot] = on
            self._active.copy_(torch.from_numpy(active_np))

        def release(slot):
            """Return a slot's pages and free it.  The device stream runs
            the enqueued reads of the old pages before any later write, so
            pending output refs stay valid."""
            sched.recycle(slot)
            set_active(slot, 0)
            if slot in prefilling:
                prefilling.remove(slot)
            self._upload_tables()

        def handle_token(slot, g, tok):
            req = live.get((slot, g))
            if req is None:                       # post-eos stragglers
                return
            if req.first_token_t == 0.0:
                req.first_token_t = time.monotonic()
                ttft = req.first_token_t - req.submit_t
                stats.first_token_times.append(ttft)
                metrics.histogram("serve.ttft_s").record(ttft)
            if eos_id is not None and tok == eos_id:
                live.pop((slot, g))
                if sched.running.get(slot) is req:
                    release(slot)
                return
            outputs[req.rid].append(tok)

        def process(bucket):
            for entry in bucket:
                kind = entry[0]
                if kind == "p":                   # prefill's first token
                    _, slot, g, ref = entry
                    handle_token(slot, g, int(ref))
                elif kind == "d":                 # one decode step
                    _, ref, gens = entry
                    arr = ref.cpu().numpy()
                    for slot in np.nonzero(gens)[0]:
                        handle_token(int(slot), int(gens[slot]),
                                     int(arr[slot]))
                else:                             # attribution complete
                    _, slot, g = entry
                    live.pop((slot, g), None)
            bucket.clear()

        it = 0
        tracer = obs_trace.TRACER
        while to_submit or sched.queue or sched.running \
                or pending_old or pending_cur:
            t_iter = time.monotonic()
            emitted = 0

            with tracer.span("serve.admit", cat="serve"):
                # 1. submissions, as far as the admission queue takes them
                while to_submit and len(sched.queue) < sched.queue_depth:
                    req = to_submit.pop(0)
                    req.submit_t = time.monotonic()
                    sched.submit(req)

                # 2. admission: rewrites table/lens contents, never shapes
                admitted = False
                while (req := sched.admit_next()) is not None:
                    gen_of[req.slot] += 1
                    live[(req.slot, gen_of[req.slot])] = req
                    prefilling.append(req.slot)
                    admitted = True
                if admitted:
                    self._upload_tables()

            # 3. one prefill chunk for the oldest prefilling slot
            if prefilling:
                slot = prefilling[0]
                req = live[(slot, gen_of[slot])]
                valid = min(C, req.prompt_len - req.prefilled)
                with tracer.span("serve.prefill_chunk", cat="serve",
                                 slot=slot, offset=req.prefilled,
                                 valid=valid):
                    chunk = np.zeros((C,), np.int32)
                    chunk[:valid] = req.prompt[req.prefilled:
                                               req.prefilled + valid]
                    logits, self.state = self.lm.prefill_chunk(
                        self.params, self.state,
                        torch.from_numpy(chunk).to(self.device), slot,
                        req.prefilled, valid)
                req.prefilled += valid
                sched.lens[slot] = req.prefilled      # lockstep mirror
                if req.prefilled >= req.prompt_len:
                    prefilling.pop(0)
                    tok = sample_token(gen, logits[None], self.sampling)[0]
                    cur = torch.where(
                        torch.arange(B, device=self.device) == slot, tok, cur)
                    pending_cur.append(("p", slot, int(gen_of[slot]), tok))
                    emitted += 1
                    budget[slot] = req.max_new - 1
                    if budget[slot] > 0:
                        set_active(slot, 1)
                    else:                 # budget spent: free the slot now
                        release(slot)
                        pending_cur.append(("drain", slot,
                                            int(gen_of[slot])))

            # 4. one batched decode step over the active slots
            n_active = int((active_np > 0).sum())
            if n_active:
                with tracer.span("serve.decode", cat="serve",
                                 active=n_active):
                    cur = self._decode(cur, gen)
                pending_cur.append(("d", cur, np.where(active_np > 0, gen_of,
                                                       0)))
                on = active_np > 0
                emitted += n_active
                sched.lens[on] += 1                   # lockstep mirror
                budget[on] -= 1
                # budget exhaustion is host-exact: release now, leaving a
                # lagged attribution marker for the demux
                for slot in np.nonzero(on & (budget <= 0))[0]:
                    release(int(slot))
                    pending_cur.append(("drain", int(slot),
                                        int(gen_of[slot])))

            # 5. window boundary: demux the previous window
            it += 1
            if it % self.EOS_CHECK_EVERY == 0:
                with tracer.span("serve.demux", cat="serve",
                                 window=len(pending_old)):
                    process(pending_old)
                pending_old, pending_cur = pending_cur, pending_old

            dt = time.monotonic() - t_iter
            occ = n_active / B
            if emitted:
                metrics.counter("serve.tokens").inc(emitted)
                metrics.histogram("serve.token_latency_s").record(
                    dt, n=emitted)
            if occ > 0:
                # the decoding occupancy per iteration; the scheduler
                # exports the instantaneous gauge
                metrics.histogram("serve.occupancy_dist").record(occ)
            self.heartbeats.post(self.worker, it, occupancy=occ)
            if collect_stats:
                stats.iter_times.append(dt)
                stats.tokens_per_iter.append(emitted)
                stats.occupancy.append(occ)
                stats.token_latencies.extend([dt] * emitted)

        process(pending_old)
        process(pending_cur)
        outs = [np.asarray(outputs[r.rid], np.int32) for r in reqs]
        return (outs, stats) if collect_stats else outs
