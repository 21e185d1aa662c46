"""Continuous-batching serving engine with a hot-swappable model (the port of
the JAX package's ``serving/engine.py``).

One fixed block of ``slots`` batch rows shares a single decode step; every
row carries its own position (``state["pos"]``: (slots,) int64), so
sessions prefill into free rows and decode in lock-step regardless of where
each one is in its sequence. Scheduling per step: admit waiting requests
into free slots (one prefill each, kernel K3 on the card), then advance
every live slot: one token through the vanilla decode step, or up to
``spec_k + 1`` tokens through a draft/verify speculative round when a
drafter is resident (the pre-hop model, handed over by the hop controller
after a successful swap; ``serving.speculative``).

**KV layout.** The default is *paged*: slots share a pool of fixed-size
blocks through per-slot page tables (``serving.kv_pages``), so a slot pays
for the pages its sequence actually covers instead of a dense ``max_len``
row. The dense layout survives behind ``kv_layout="dense"`` as the
correctness oracle (and for windowed configs and the recurrent families,
which the paged path does not cover). The engine owns positions host-side
(``self.pos_host``) and re-asserts them into the device state before every
launch; that single convention is also what makes speculative rollback
free: a rejected draft just means the position does not advance over it.

**Recurrent families** (xLSTM, ``family="ssm"``, and the Mamba2 hybrid):
each slot's row of the tuple decode state holds its session's recurrent
state, which absorbs every token it is fed. So these families prefill at
each request's true length, never right-padded (an attention cache never
reads its padded rows; a recurrent state would take them in), and a
re-prefill after a hop runs over each session's history at its length;
``insert`` overwrites every leaf of the slot's row
(``models.model.write_slot``). The hop migrates their state by re-prefill
only, and speculation, whose rollback is positional, is refused
(:func:`refuse_recurrent`).

The engine's serving buffers, ``(cfg, params, state)`` plus the prefill,
decode and insert functions, are swapped as a unit by :meth:`install`,
which the hop controller (``repro_torch.serving.hotswap``) calls between
two decode steps. Decode and insert write the live state in place, but a
hop builds its migrated state into new tensors, so a hop aborted at any
stage leaves the engine decoding the old weights untouched.
"""
from __future__ import annotations

import functools
import time
import warnings
from collections import Counter, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import (_pad_attn_caches, decode_step, forward,
                                      init_decode_state, unembed, write_slot)
from repro_torch.serving import speculative as spec
from repro_torch.serving.admission import AdmissionQueue, Request
from repro_torch.serving.kv_pages import (PageAllocator, init_paged_caches,
                                          paged_supported, scatter_row_blocks)

_EMA = 0.3          # telemetry smoothing for acceptance and launch costs
_RECENT_STEPS = 4096  # exact-window size behind decode_step_percentiles
RECURRENT = ("ssm", "hybrid")   # families with a recurrent decode state


def exact_length_prefill(cfg: ModelConfig) -> bool:
    """True where a prefill must run at the request's true length: the
    recurrent families, whose state would absorb a right pad."""
    return cfg.family in RECURRENT


@functools.lru_cache(maxsize=16)
def make_serving_fns(cfg: ModelConfig, cap: int, layout: str = "dense",
                     want_hidden: bool = False,
                     use_kernel: Optional[bool] = None):
    """(prefill_one, decode_many, insert) for one architecture.

    Memoised on the arguments (configs are frozen dataclasses), so a hop
    back to an architecture already served, or a second engine on the same
    config, reuses them. ``cap`` is the cache row capacity: the
    (window-clamped) ``max_len`` for the dense layout, the page-aligned
    ``padded_len`` for the paged one. With ``layout="paged"`` the state
    carries ``{"caches": pools, "pos", "pages"}`` and ``insert`` scatters
    the prefilled row into the slot's pages; decode gathers through the
    table. ``want_hidden`` also returns the pre-final-norm residual stream
    (prefill: (1, Tp, D); decode: (B, 1, D)), which the engine keeps per
    slot so a depth-only hop can replay just the new layers.
    ``use_kernel`` picks the prefill attention route
    (``models.layers.full_attention``: ``None`` is K3 on the card).

    ``prefill_one`` takes a (1, Tp) prompt plus its true length and
    returns the logits at ``true_len - 1``. An attention family's prompt is
    right-padded: padding positions write garbage cache entries *beyond*
    the session's position, and decode overwrites each one exactly when it
    becomes valid, so they are never attended to. A recurrent family's
    prompt comes at its true length (:func:`exact_length_prefill`); only
    the hybrid's attention caches are padded to ``cap``. A dense ``insert``
    writes every leaf of the slot's row (``models.model.write_slot``).
    """
    if layout not in ("dense", "paged"):
        raise ValueError(f"unknown KV layout {layout!r}")
    if exact_length_prefill(cfg) and layout != "dense":
        raise ValueError(f"{cfg.name}: a recurrent state has no paged "
                         f"layout; serve it dense")

    @torch.no_grad()
    def prefill_one(params, tokens, true_len: int):
        out = forward(params, cfg, {"tokens": tokens}, mode="prefill",
                      use_kernel=use_kernel, return_prenorm=want_hidden)
        caches = _pad_attn_caches(out[1], cap)
        logits = unembed(params, cfg, out[0][0, true_len - 1])
        if want_hidden:
            return logits, caches, out[2]
        return logits, caches

    @torch.no_grad()
    def decode_many(params, state, tokens):
        return decode_step(params, cfg, state, {"tokens": tokens},
                           return_prenorm=want_hidden)

    @torch.no_grad()
    def insert(state, caches1, pos1: int, slot: int):
        if layout == "dense":
            write_slot(state["caches"], caches1, slot)
        else:
            for kk in ("k", "v"):
                scatter_row_blocks(state["caches"][kk], state["pages"][slot],
                                   caches1[kk][:, 0])
        pos = state["pos"].clone()
        pos[slot] = pos1
        return {**state, "pos": pos}

    return prefill_one, decode_many, insert


def refuse_recurrent(cfg: ModelConfig, spec_k: int) -> None:
    """Speculation on a recurrent family is out of scope: its rollback is
    positional (a rejected draft is a position that does not advance),
    which cannot undo drafted tokens a recurrent state has absorbed."""
    if spec_k > 0 and cfg.family in RECURRENT:
        raise NotImplementedError(
            f"{cfg.name}: speculative decoding (spec_k={spec_k}) does not "
            f"serve the recurrent family {cfg.family!r}: its positional "
            f"rollback cannot undo drafted tokens in a recurrent state "
            f"(ROADMAP.md, 'the other families, e2: speculation for "
            f"recurrent families')")


def refuse_inputs(cfg: ModelConfig) -> None:
    """The engine feeds its model tokens only, as the JAX package's engine
    does (its prefill and decode build ``{"tokens": ...}``): a model that
    needs more in its batch has no path through either engine."""
    need = {"audio": "frames", "vlm": "M-RoPE positions and patch "
            "embeddings", "vision": "patches"}.get(cfg.modality)
    if need is not None:
        raise ValueError(
            f"{cfg.name}: the serving engine feeds tokens only, as the JAX "
            f"package's engine does, and a {cfg.modality} model needs "
            f"{need}; serve it on the lock-step path (serve without "
            f"--live-grow-at)")


class ServingEngine:
    """Continuous batching over ``slots`` sessions with admission control.

    ``prompt_budget`` bounds admissible prompt length (longer: rejected at
    the door); ``max_len = prompt_budget + gen_budget`` is each slot's cache
    budget, and a request's ``max_new`` is clamped so it can never outrun
    its slot.

    ``kv_layout``/``block_size``/``pool_blocks`` control the paged cache
    (``pool_blocks=None`` sizes the pool so admission never blocks; smaller
    pools create real backpressure: admission reserves a request's worst
    case up front, so admitted requests always finish);
    ``temperature``/``top_p``/``seed`` select sampling on the (verifier's)
    logits with a reproducible per-request Philox chain, greedy by default;
    ``spec_k`` arms speculative decoding: drafting starts when a hop hands
    the pre-hop model over through :meth:`adopt_drafter`, and stops for good
    when the measured speedup estimate drops below 1, unless
    ``spec_autodisable=False`` (the estimate reads wall clocks, so
    deterministic runs turn it off); a recurrent family refuses it. A
    recurrent family falls back from ``kv_layout="paged"`` to its dense
    state with a warning, and keeps no residual stream. ``device`` is
    where ``params`` must lie: the card unless the caller asks for the
    CPU. ``use_kernel`` as in :func:`make_serving_fns` (the hop's grow
    takes it too: ``False`` is the plain route, K1 and K3 off).
    """

    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 prompt_budget: int = 64, gen_budget: int = 32,
                 queue_capacity: int = 64, kv_layout: str = "paged",
                 block_size: int = 16, pool_blocks: Optional[int] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: int = 0, spec_k: int = 0,
                 spec_autodisable: bool = True,
                 keep_residual: Optional[bool] = None,
                 use_kernel: Optional[bool] = None, device="cuda"):
        if kv_layout not in ("paged", "dense"):
            raise ValueError(f"unknown KV layout {kv_layout!r}")
        refuse_recurrent(cfg, spec_k)
        refuse_inputs(cfg)
        self.device = resolve_device(device)
        leaf = params["final_norm"]["scale"]
        if leaf.device.type != self.device.type:
            raise ValueError(f"params lie on {leaf.device}, the engine was "
                             f"asked to serve on {self.device}")
        self.slots = slots
        self.prompt_budget = prompt_budget
        self.max_len = prompt_budget + gen_budget
        self.use_kernel = use_kernel
        self.queue = AdmissionQueue(queue_capacity)
        self.requests: List[Request] = []
        self.slot_req: List[Optional[Request]] = [None] * slots
        # decode steps as (wall ms, tokens emitted): a bounded recent window
        # (exact percentiles and tok/s for the report) + a histogram of the
        # walls (full-run p50/p99 in O(buckets) memory)
        self._recent_steps: deque = deque(maxlen=_RECENT_STEPS)
        self._h_step = obs.histogram("serve.decode.step_ms")
        self._h_queue_wait = obs.histogram("serve.request.queue_wait_ms")
        self._h_ttft = obs.histogram("serve.request.ttft_ms")
        self._h_tok_s = obs.histogram("serve.request.tokens_per_s",
                                      buckets=obs.RATE_BUCKETS)
        self._h_draft = obs.histogram("serve.spec.draft_ms")
        self._h_verify = obs.histogram("serve.spec.verify_ms")
        self._g_acc = obs.gauge("serve.spec.acc_ema")
        self._g_est = obs.gauge("serve.spec.est_speedup")
        self._c_req = obs.counter_group("serve.requests")
        for k in ("submitted", "done", "rejected", "dropped", "deferred"):
            self._c_req.inc(k, 0)       # declare: explicit zeros
        # prefills this engine ran, keyed (config name, "admit" | "draft" |
        # "reprefill"): each is one K3 launch per attention layer on the
        # card; prefill_lengths adds the tokens each one ran over (the
        # shape K3 saw) to the key
        self.prefill_counts: Counter = Counter()
        self.prefill_lengths: Counter = Counter()
        self.decode_steps = 0
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.spec_k = int(spec_k)
        self.spec_autodisable = bool(spec_autodisable)
        self.kv_layout_requested = kv_layout
        self.kv_fallback = False
        if kv_layout == "paged" and not paged_supported(cfg):
            # windowed: dense ring cache; recurrent: a dense tuple state.
            # Fall back loudly: a silent switch would make the serve report
            # lie about the layout.
            kv_layout = "dense"
            self.kv_fallback = True
            warnings.warn(
                f"{cfg.name}: paged KV layout unsupported "
                f"(family={cfg.family!r}, window={cfg.window}); serving "
                "with the dense ring cache instead", stacklevel=2)
        self.kv_layout = kv_layout
        self.alloc: Optional[PageAllocator] = None
        if kv_layout == "paged":
            self.alloc = PageAllocator(slots, self.max_len, block_size,
                                       pool_blocks, device=self.device)
        if keep_residual is None:
            keep_residual = paged_supported(cfg)
        self.keep_residual = bool(keep_residual) and paged_supported(cfg)
        self.pos_host = np.zeros((slots,), np.int64)
        self.resid: Optional[np.ndarray] = None
        self.resid_from = np.zeros((slots,), np.int64)
        # drafter (speculative decoding): installed by adopt_drafter
        self.d_cfg: Optional[ModelConfig] = None
        self.d_params = None
        self.d_state = None
        self.spec_enabled = False
        self.spec_stats: Dict[str, Any] = {}
        self.install(cfg, params, None)

    # -- serving buffers ----------------------------------------------------
    def _cap_for(self, cfg: ModelConfig) -> int:
        if self.kv_layout == "paged":
            return self.alloc.padded_len
        return min(cfg.window, self.max_len) if cfg.window else self.max_len

    def _fns(self, cfg: ModelConfig):
        return make_serving_fns(cfg, self._cap_for(cfg), self.kv_layout,
                                self.keep_residual, self.use_kernel)

    def fresh_state(self, cfg: ModelConfig):
        pos = torch.zeros((self.slots,), dtype=torch.long, device=self.device)
        if self.kv_layout == "paged":
            return {"caches": init_paged_caches(cfg, self.alloc.n_blocks,
                                                self.alloc.block_size,
                                                device=self.device),
                    "pos": pos, "pages": self.alloc.device_table()}
        st = init_decode_state(cfg, self.slots, self.max_len,
                               device=self.device)
        return {"caches": st["caches"], "pos": pos}

    def install(self, cfg: ModelConfig, params, state) -> None:
        """Swap the serving buffers (the final act of a hop). The new
        functions are made first, so the visible mutation is reference
        assignment between two decode steps."""
        if self.kv_layout == "paged" and not paged_supported(cfg):
            raise ValueError(f"{cfg.name}: paged KV unsupported; use "
                             "kv_layout='dense'")
        cap = self._cap_for(cfg)
        fns = self._fns(cfg)
        if state is None:
            state = self.fresh_state(cfg)
        if obs.active_ledger() is not None:
            # the measured-cost pass, on fake tensors (no launch, no state
            # change): the decode step's counted FLOPs against 2N a token
            from repro_torch.obs import costs
            costs.measure_step(
                f"decode_step[{cfg.name}]", fns[1], params, state,
                torch.zeros((self.slots, 1), dtype=torch.long,
                            device=self.device),
                modelled_flops=2.0 * cfg.active_param_count() * self.slots,
                per_call_units=self.slots)
        hopped = hasattr(self, "cfg")
        if hopped:
            obs.event("serve.install", src=self.cfg.name, dst=cfg.name,
                      live=len(self.live))
        self.cfg, self.params, self.state = cfg, params, state
        self.cap = cap
        self._prefill, self._decode, self._insert = fns
        if self.keep_residual:
            if (self.resid is None
                    or self.resid.shape != (self.slots, cap, cfg.d_model)):
                self.resid = np.zeros((self.slots, cap, cfg.d_model),
                                      np.float32)
                self.resid_from[:] = self.pos_host
            elif hopped:
                # pre-hop residuals describe the old model's function
                self.resid_from[:] = self.pos_host

    # -- speculative drafter -------------------------------------------------
    def adopt_drafter(self, cfg1: ModelConfig, params1, state1) -> bool:
        """Keep the pre-hop model resident as a speculative drafter. Its
        decode state is the live pre-hop state (a hop builds the grown
        state into new tensors, so the old one is intact and shares no
        storage with it): its caches already hold every slot's history, so
        drafting starts on the next round, and with a lossless (LEMON) hop
        the first round's acceptance is 100% by construction. With the
        paged layout the drafter keeps its own block pool (its widths, its
        own spare block) behind the engine's page table.

        Declined (returns False, nothing kept) without ``spec_k > 0``, for a
        windowed config on either side (a ring cache cannot take positional
        rollback), a vocabulary mismatch, a drafter the paged layout does
        not support, or a different cache capacity.
        """
        if self.spec_k <= 0 or cfg1.window or self.cfg.window:
            return False
        if cfg1.vocab_size != self.cfg.vocab_size:
            return False
        if self.kv_layout == "paged" and not paged_supported(cfg1):
            return False
        if self._cap_for(cfg1) != self.cap:
            return False
        self.d_cfg, self.d_params, self.d_state = cfg1, params1, state1
        self._d_prefill, _, self._d_insert = make_serving_fns(
            cfg1, self.cap, self.kv_layout, False, self.use_kernel)
        if self.temperature > 0:
            self._draft = spec.make_sampled_draft_fn(
                cfg1, self.spec_k, self.temperature, self.top_p)
        else:
            self._draft = spec.make_draft_fn(cfg1, self.spec_k)
        self._verify = spec.make_verify_fn(self.cfg, self.spec_k + 1,
                                           self.keep_residual)
        self.spec_enabled = True
        self.spec_stats = {"rounds": 0, "accepted": 0, "drafted": 0,
                           "acc_ema": None, "first_round_acc": None,
                           "c_draft": None, "c_verify": None,
                           "est_speedup": None, "drafter": cfg1.name,
                           "disabled": None}
        return True

    def drop_drafter(self, reason: str = "dropped") -> None:
        self.d_cfg = self.d_params = self.d_state = None
        if self.spec_enabled:
            self.spec_stats["disabled"] = reason
        self.spec_enabled = False

    # -- request lifecycle --------------------------------------------------
    def submit(self, prompt, max_new: int) -> Request:
        req = Request(prompt=[int(t) for t in prompt], max_new=max_new)
        req.sample_key = len(self.requests)
        req.t_submit = time.perf_counter()
        self.requests.append(req)
        self._c_req.inc("submitted")
        if not (0 < len(req.prompt) <= self.prompt_budget):
            req.status = "rejected"
            self.queue.rejected += 1
            self._c_req.inc("rejected")
            return req
        req.max_new = min(max_new, self.max_len - len(req.prompt))
        self.queue.submit(req)
        return req

    @property
    def live(self) -> List[Request]:
        return [r for r in self.slot_req if r is not None]

    def counts(self) -> Dict[str, int]:
        c = {"done": 0, "running": 0, "queued": 0, "rejected": 0,
             "dropped": 0}
        for r in self.requests:
            c[r.status] = c.get(r.status, 0) + 1
        return c

    def has_work(self) -> bool:
        return bool(len(self.queue)) or any(
            r is not None for r in self.slot_req)

    # -- decode-step timing ---------------------------------------------------
    def _observe_step(self, ms: float, n_tokens: int) -> None:
        self._recent_steps.append((ms, n_tokens))
        self._h_step.observe(ms)

    def decode_step_ms(self, steps: Optional[Tuple[int, int]] = None
                       ) -> List[float]:
        """The recent window's decode-step walls (ms); ``steps=(a, b)``
        takes decode steps a..b-1 of the window alone (b None: to the
        end)."""
        arr = [ms for ms, _ in self._recent_steps]
        return arr if steps is None else arr[steps[0]:steps[1]]

    def decode_step_percentiles(self, *qs: float,
                                steps: Optional[Tuple[int, int]] = None
                                ) -> Tuple[float, ...]:
        """Exact percentiles over the recent decode-step window (ms), or
        over ``steps`` of it as in :meth:`decode_step_ms`."""
        arr = self.decode_step_ms(steps)
        if not arr:
            return tuple(float("nan") for _ in qs)
        return tuple(float(np.percentile(np.asarray(arr), q)) for q in qs)

    def decode_tok_s(self, steps: Optional[Tuple[int, int]] = None) -> float:
        """Tokens the decode steps (or speculative rounds) of the recent
        window emitted, over their walls, per second; ``steps`` as in
        :meth:`decode_step_ms`."""
        win = list(self._recent_steps)
        if steps is not None:
            win = win[steps[0]:steps[1]]
        ms = sum(m for m, _ in win)
        return sum(n for _, n in win) / (ms / 1e3) if ms > 0 else float("nan")

    # -- host-side sampling --------------------------------------------------
    def _pick_token(self, req: Request, logits_row: np.ndarray) -> int:
        if self.temperature <= 0:
            return int(np.argmax(logits_row))
        p = spec.adjust_probs(logits_row, self.temperature, self.top_p)
        rng = spec.philox(self.seed, req.sample_key, req.n_draws)
        req.n_draws += 1
        return int(rng.choice(len(p), p=p))

    # -- scheduling ---------------------------------------------------------
    def _sync_state(self, state):
        """Re-assert host truth into a device state before a launch: the
        per-slot positions and the current page table."""
        out = {**state, "pos": torch.as_tensor(self.pos_host,
                                               device=self.device)}
        if self.alloc is not None:
            out["pages"] = self.alloc.device_table()
        return out

    def _worst_len(self, req: Request) -> int:
        """Worst-case backed length: prompt + full budget + the farthest a
        speculative verify can write ahead of the final position."""
        return min(len(req.prompt) + req.max_new + max(self.spec_k, 0),
                   self.cap)

    def _tokens(self, rows) -> torch.Tensor:
        return torch.as_tensor(np.asarray(rows, np.int64), device=self.device)

    @staticmethod
    def _prompt_row(cfg: ModelConfig, hist, pad_to: int) -> np.ndarray:
        """(1, n) tokens of one prefill: ``hist`` right-padded to
        ``pad_to`` for an attention family, at its true length for a
        recurrent one."""
        n = len(hist) if exact_length_prefill(cfg) else pad_to
        toks = np.zeros((1, n), np.int64)
        toks[0, :len(hist)] = hist
        return toks

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.slot_req[slot] is not None:
                continue
            if self.alloc is not None:
                head = self.queue.peek()
                if head is None:
                    return
                if not self.alloc.can_admit(self._worst_len(head)):
                    self._c_req.inc("deferred")
                    return              # stays queued: deferred, never dropped
            req = self.queue.pop()
            if req is None:
                return
            self._h_queue_wait.observe(
                (time.perf_counter() - req.t_submit) * 1e3)
            req.true_len = len(req.prompt)
            if self.alloc is not None:
                self.alloc.admit(slot, req.true_len, self._worst_len(req))
            toks = self._prompt_row(self.cfg, req.prompt, self.prompt_budget)
            with obs.span("serve.prefill", slot=slot, uid=req.uid,
                          prompt_len=req.true_len):
                out = self._prefill(self.params, self._tokens(toks),
                                    req.true_len)
                self._count_prefill(self.cfg, "admit", toks)
                self.state = self._insert(self._sync_state(self.state),
                                          out[1], req.true_len, slot)
            self.pos_host[slot] = req.true_len
            if self.keep_residual:
                h = out[2][0].float().cpu().numpy()
                self.resid[slot, :req.true_len] = h[:req.true_len]
                self.resid_from[slot] = 0
            if self.d_cfg is not None:
                # the drafter's cache needs every admitted prompt too
                d_out = self._d_prefill(self.d_params, self._tokens(toks),
                                        req.true_len)
                self._count_prefill(self.d_cfg, "draft", toks)
                self.d_state = self._d_insert(self._sync_state(self.d_state),
                                              d_out[1], req.true_len, slot)
            req.first_logits = out[0].float().cpu().numpy()
            req.tokens.append(self._pick_token(req, req.first_logits))
            req.t_first = time.perf_counter()
            self._h_ttft.observe((req.t_first - req.t_submit) * 1e3)
            req.status, req.slot = "running", slot
            self.slot_req[slot] = req
            self._finish_if_done(req)
            if req.status == "done":
                req.last_logits = req.first_logits

    def _count_prefill(self, cfg: ModelConfig, kind: str, toks) -> None:
        self.prefill_counts[(cfg.name, kind)] += 1
        self.prefill_lengths[(cfg.name, kind, toks.shape[1])] += 1

    def _finish_if_done(self, req: Request) -> None:
        if (len(req.tokens) >= req.max_new
                or req.true_len + len(req.tokens) >= self.max_len):
            req.status = "done"
            req.t_done = time.perf_counter()
            self._c_req.inc("done")
            dt = req.t_done - req.t_submit
            if dt > 0:
                self._h_tok_s.observe(len(req.tokens) / dt)
            self.slot_req[req.slot] = None
            if self.alloc is not None:
                self.alloc.release(req.slot)
            self.pos_host[req.slot] = 0
        else:
            self.pos_host[req.slot] = req.true_len + len(req.tokens) - 1

    def _spec_ready(self, active) -> bool:
        if not (self.spec_enabled and self.d_cfg is not None
                and self.spec_k > 0):
            return False
        K = self.spec_k
        return all(self.pos_host[i] + K + 1 <= self.cap for i, _ in active)

    def step(self) -> bool:
        """One scheduling iteration. Returns True while work remains."""
        self._admit()
        active = [(i, r) for i, r in enumerate(self.slot_req)
                  if r is not None]
        if active:
            if self._spec_ready(active):
                self._spec_round(active)
            else:
                self._plain_round(active)
        return self.has_work()

    def _plain_round(self, active) -> None:
        if self.alloc is not None:
            for i, _ in active:
                self.alloc.ensure(i, int(self.pos_host[i]) + 1)
        last = np.zeros((self.slots, 1), np.int64)
        for i, r in active:
            last[i, 0] = r.tokens[-1]
        state = self._sync_state(self.state)
        t0 = time.perf_counter()
        out = self._decode(self.params, state, self._tokens(last))
        L = out[0].float().cpu().numpy()         # waits for the step
        self._observe_step((time.perf_counter() - t0) * 1e3, len(active))
        self.decode_steps += 1
        self.state = out[1]
        if self.keep_residual:
            h = out[2][:, 0].float().cpu().numpy()
        for i, r in active:
            if self.keep_residual:
                self.resid[i, self.pos_host[i]] = h[i]
            r.tokens.append(self._pick_token(r, L[i]))
            self._finish_if_done(r)
            if r.status == "done":
                r.last_logits = L[i].copy()

    def _append_tokens(self, req: Request, toks) -> int:
        """Append until the request's budget stops it; returns #appended."""
        n = 0
        for t in toks:
            req.tokens.append(int(t))
            n += 1
            if (len(req.tokens) >= req.max_new
                    or req.true_len + len(req.tokens) >= self.max_len):
                break
        return n

    def _spec_round(self, active) -> None:
        K = self.spec_k
        if self.alloc is not None:
            # every draft and verify write at pos..pos+K lands on a block of
            # its own slot, none in the spare block (the admission reserve
            # covers the K extra rows)
            for i, _ in active:
                self.alloc.ensure(i, int(self.pos_host[i]) + K + 1)
        last = np.zeros((self.slots, 1), np.int64)
        for i, r in active:
            last[i, 0] = r.tokens[-1]
        d_state = self._sync_state(self.d_state)
        state = self._sync_state(self.state)
        last_t = self._tokens(last)
        t0 = time.perf_counter()
        if self.temperature > 0:
            noise = spec.draft_noise(self.seed, self.spec_stats["rounds"],
                                     K + 1, self.slots, self.cfg.vocab_size,
                                     self.device)
            toks, probs, d_state2 = self._draft(self.d_params, d_state,
                                                last_t, noise)
        else:
            toks, probs, d_state2 = self._draft(self.d_params, d_state,
                                                last_t)
        draft_toks = toks.cpu().numpy()              # waits for the drafts
        t1 = time.perf_counter()
        inputs = np.concatenate([last, draft_toks.astype(np.int64)], axis=1)
        v_out = self._verify(self.params, state, self._tokens(inputs))
        L = v_out[0].float().cpu().numpy()            # (slots, K+1, V)
        t2 = time.perf_counter()
        self.decode_steps += 1
        hid = (v_out[1].float().cpu().numpy() if self.keep_residual
               else None)
        self.d_state = d_state2
        self.state = v_out[-1]
        draft_probs = (probs.cpu().numpy() if self.temperature > 0
                       else None)
        acc_total = n_emitted = 0
        for i, r in active:
            if self.temperature > 0:
                emit, a, draws = spec.accept_sampled(
                    draft_toks[i], draft_probs[i], L[i],
                    temperature=self.temperature, top_p=self.top_p,
                    seed=self.seed, uid=r.sample_key, counter=r.n_draws)
                r.n_draws += draws
            else:
                emit, a = spec.accept_greedy(draft_toks[i], L[i])
            acc_total += a
            r.acc_ema = (a / K if r.acc_ema is None
                         else _EMA * (a / K) + (1 - _EMA) * r.acc_ema)
            if hid is not None:
                p0 = int(self.pos_host[i])
                self.resid[i, p0:p0 + K + 1] = hid[i]
            n = self._append_tokens(r, emit)
            n_emitted += n
            self._finish_if_done(r)
            if r.status == "done":
                r.last_logits = L[i, n - 1].copy()
        self._observe_step((t2 - t0) * 1e3, n_emitted)
        self._spec_telemetry(len(active), acc_total, t1 - t0, t2 - t1)

    def _spec_telemetry(self, n_active: int, acc_total: int,
                        t_draft: float, t_verify: float) -> None:
        """Acceptance and launch-cost EMAs, and the speedup estimate
        ``(acc * K + 1) / (1 + K * c_draft / c_verify)``, with ``c_draft``
        the drafting wall per drafted token and ``c_verify`` the wall of
        one verify: the JAX package's formula, where a verify is one launch
        costing about one vanilla step. Here a verify is K+1 decode steps,
        so the estimate overstates the speedup a round really gives."""
        st = self.spec_stats
        K = self.spec_k
        mean_a = acc_total / max(1, n_active)
        if st["rounds"] == 0:
            st["first_round_acc"] = mean_a / K
        st["rounds"] += 1
        st["accepted"] += acc_total
        st["drafted"] += n_active * K
        ema = lambda old, new: (new if old is None                  # noqa: E731
                                else _EMA * new + (1 - _EMA) * old)
        st["acc_ema"] = ema(st["acc_ema"], mean_a / K)
        st["c_draft"] = ema(st["c_draft"], t_draft / K)   # per drafted token
        st["c_verify"] = ema(st["c_verify"], t_verify)    # per verify
        est = ((st["acc_ema"] * K + 1)
               / (1 + K * st["c_draft"] / max(st["c_verify"], 1e-9)))
        st["est_speedup"] = est
        self._h_draft.observe(t_draft * 1e3)
        self._h_verify.observe(t_verify * 1e3)
        self._g_acc.set(st["acc_ema"])
        self._g_est.set(est)
        if self.spec_autodisable and st["rounds"] >= 3 and est < 1.0:
            self.spec_enabled = False
            st["disabled"] = (f"est speedup {est:.2f}x < 1 after "
                              f"{st['rounds']} rounds")
            print(f"[spec] drafting auto-disabled: {st['disabled']}")

    def run(self, *, on_step=None, max_steps: int = 100_000) -> None:
        """Drain the queue; ``on_step(engine)`` runs between decode steps:
        the hop controller's ``poll`` hooks in here."""
        for _ in range(max_steps):
            more = self.step()
            if on_step is not None:
                on_step(self)
            if not more:
                return
        raise RuntimeError(f"engine did not drain in {max_steps} steps")

    # -- cache migration fallback -------------------------------------------
    def reprefill_state(self, params, cfg: ModelConfig):
        """The universal cache-migration fallback: rebuild every live
        session's decode state by re-running prefill over its token history
        under ``params``/``cfg``, into a fresh state. Exact by construction
        (it *is* the grown model's own prefill), at the cost of one
        ``max_len`` forward per live session (one at the history's length
        for a recurrent family)."""
        prefill_one, _, insert = self._fns(cfg)
        state = self.fresh_state(cfg)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            # the cache holds prompt + every generated token but the newest
            # (decode writes its *input* token); the same layout here
            hist = (list(req.prompt) + list(req.tokens))[:-1]
            toks = self._prompt_row(cfg, hist, self.max_len)
            out = prefill_one(params, self._tokens(toks), len(hist))
            self._count_prefill(cfg, "reprefill", toks)
            state = insert(self._sync_paged(state), out[1], len(hist), slot)
        return state

    def _sync_paged(self, state):
        if self.alloc is not None:
            return {**state, "pages": self.alloc.device_table()}
        return state

    # -- depth-replay fast path ---------------------------------------------
    def replay_ready(self) -> bool:
        """True when every live slot's preserved residual stream covers its
        whole history (a post-hop slot only recovers coverage once it is
        re-admitted, since pre-hop residuals describe the old model)."""
        return (self.keep_residual and self.resid is not None
                and all(self.resid_from[i] == 0
                        for i, r in enumerate(self.slot_req)
                        if r is not None))
