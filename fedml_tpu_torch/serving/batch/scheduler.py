"""DecodeScheduler — the continuous-batching core (counterpart of
``fedml_tpu/serving/batch/scheduler.py``).

One DECODE step advances every in-flight request by one token: ``[S]``
slots, each step one-token work per slot against the paged KV cache. A
PREFILL program writes a prompt into the cache in fixed-size chunks.
Everything per-request — occupancy, positions, block tables, adapter
indices, temperatures, seeds — enters the programs as DATA, copied from
host mirrors to the device every step, so admits, evictions and the
adapter mix never change a program's shapes, and host mirrors and device
state cannot drift apart.

The nine programs of the JAX package's ``_build_programs`` are torch
functions here, run eagerly on the scheduler's device: ``sample``,
``decode_step`` / ``decode_write``, ``prefill_chunk`` / ``chunk_write``,
``prefill_wave`` / ``wave_write`` and ``cow_read`` / ``cow_write``. Each
compute half reads the pools; each write half scatters into them in place
(``index_put_``), which is what buffer donation gives the JAX package.
They run through one named call point, :meth:`DecodeScheduler._dispatch`,
the compute-plane seam (``core/obs/roofline.py``): every dispatch's
abstract signature feeds recompile forensics (an eager program builds
nothing, so it never fires here), and with ``roofline`` (default: the
``obs_roofline`` process default) each program is captured once per
(name, signature) on copies of its inputs before its dispatch.

Sampling is stateless per (seed, position): the token for position ``p``
uses ``fold_in(PRNGKey(seed), p)`` — the Gumbel noise is drawn on the host
with :mod:`fedml_tpu_torch.prng` (bit-equal to ``jax.random``), only for
slots with ``temperature > 0`` — so a request's sample path does not
depend on its slot or on what else is in flight. Greedy slots never touch
it.

Shared-prefix cache (``prefix_cache=True``): admissions consult a
:class:`~fedml_tpu_torch.llm.kv_cache.PrefixIndex` keyed on exact block
token content. Fully matched prompt blocks are ALIASED into the new slot's
table (refcounted, never written by it); the first partially matched
block is copied once (copy-on-write) and only the novel suffix is
prefilled. Piggybacked prefill (``prefill_batch > 1``): an admission
wave's chunks run through ONE ``[B, C]`` batched prefill pass.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ... import prng
from ...core.obs import metrics as obs_metrics
from ...core.obs import roofline as obs_roofline
from ...llm import kv_cache as kvc
from ...llm.lora import lora_select

Params = Dict[str, torch.Tensor]
logger = logging.getLogger(__name__)


@dataclasses.dataclass
class _PendingAdmit:
    """Blocks + slot reserved, prefix matched, COW applied — everything
    host-side an admission needs before its (possibly batched) prefill
    runs. Produced by :meth:`DecodeScheduler.begin_admit`, consumed by
    :meth:`DecodeScheduler.finish_admits`."""

    slot: int
    row: np.ndarray          # the slot's block-table row
    ids: List[int]
    novel_start: int         # first position actually prefilled
    aidx: int
    temp: float
    seed: int
    info: Dict[str, Any]     # cached/novel token counts for observability


class DecodeScheduler:
    """Fixed-shape slot matrix over a paged KV cache.

    ``module``/``cfg``: the :class:`~fedml_tpu_torch.llm.model.CausalLM`
    and its config; ``base_params``: the flat parameter dict the slots
    share (on the device the scheduler runs on); ``bank``: optional
    :class:`AdapterBank` (None = no LoRA side paths). ``device``: where
    the pools and every per-step tensor live (default: the device of
    ``base_params``).
    """

    def __init__(self, module, cfg, base_params: Params, bank=None, *,
                 slots: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: int = 32,
                 prefix_cache: bool = False,
                 prefill_batch: int = 0,
                 suffix_cache: bool = False,
                 device: Optional[torch.device] = None,
                 roofline: Optional[bool] = None):
        self.device = torch.device(device) if device is not None else \
            next(iter(base_params.values())).device
        self.module = module
        self.cfg = cfg
        self.params = base_params
        self.bank = bank
        self.slots = int(slots)
        self.prefill_chunk = min(int(prefill_chunk), cfg.max_seq_len)
        # piggybacked-prefill wave width (0/1 = off, the serial path);
        # clamped to the slot count — a wave can never admit more
        self.prefill_batch = min(max(int(prefill_batch or 0), 0),
                                 self.slots)
        self.cache_cfg = kvc.KVCacheConfig(
            num_layers=cfg.num_layers, kv_heads=cfg.kv_heads,
            head_dim=cfg.head_dim, max_seq_len=cfg.max_seq_len,
            block_size=int(block_size),
            # default pool: every slot can hold a full sequence
            num_blocks=int(num_blocks) if num_blocks is not None
            else self.slots * (cfg.max_seq_len // int(block_size)))
        self.alloc = kvc.BlockAllocator(self.cache_cfg)
        # suffix caching (generated-token reuse at release) needs the
        # same exact-content index to match follow-up prompts against,
        # so turning it on implies the prefix index
        self.suffix_cache = bool(suffix_cache)
        self._index = (kvc.PrefixIndex(self.cache_cfg.block_size)
                       if (prefix_cache or self.suffix_cache) else None)
        self._kp, self._vp = kvc.init_pools(self.cache_cfg,
                                            cfg.compute_dtype, self.device)
        s, mb = self.slots, self.cache_cfg.max_blocks_per_slot
        # host mirrors of per-slot state — all DATA to the step
        self._active = np.zeros(s, bool)
        self._tables = np.full((s, mb), self.cache_cfg.trash_block,
                               np.int32)
        self._pos = np.zeros(s, np.int32)       # position of last_tok
        self._last = np.zeros(s, np.int32)      # token awaiting its step
        self._temp = np.zeros(s, np.float32)
        self._seed = np.zeros(s, np.int32)
        self._aidx = np.zeros(s, np.int32)
        self._reserved: set = set()   # slots between begin_ and finish_
        self.last_admit_info: Optional[Dict[str, Any]] = None
        self.steps_run = 0
        self.resets = 0
        # True until a decode step observes NaN/inf in an active slot's
        # logits — the watchdog's poison signal
        self.last_step_finite = True
        self._roofline = obs_roofline.DispatchTracker(enabled=roofline,
                                                      device=self.device)
        self._build_programs()

    def _dispatch(self, name: str, fn, *args):
        """Run one serving program through the compute-plane seam
        (``name`` labels the program): its signature, the opt-in capture
        (on copies: the write programs scatter into the pools in place)
        before the call, forensics after."""
        sig = obs_roofline.dispatch_signature(args)
        with torch.no_grad():
            self._roofline.maybe_capture(name, fn, args, sig=sig)
            out = fn(*args)
        # an eager program builds nothing: no compile to report
        self._roofline.observe(name, sig, 0)
        return out

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """One host mirror → the scheduler's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sampling(self, temps: Sequence[float], seeds: Sequence[int],
                  positions: Sequence[int]):
        """Per-row sampling inputs: temperatures on the device and the
        rows' Gumbel noise ``[n, vocab]`` for ``fold_in(PRNGKey(seed),
        position)`` (zeros for greedy rows), or None when every row is
        greedy."""
        temps = np.asarray(temps, np.float32)
        noise = None
        hot = np.flatnonzero(temps > 0)
        if hot.size:
            noise = np.zeros((len(temps), self.cfg.vocab_size), np.float32)
            for i in hot:
                key = prng.fold_in(prng.PRNGKey(int(seeds[i])),
                                   int(positions[i]))
                noise[i] = prng.gumbel(key, self.cfg.vocab_size)
            noise = self._dev(noise)
        return self._dev(temps), noise

    # ------------------------------------------------------------- reset --
    def reset(self) -> None:
        """Crash-only recovery (Candea & Fox): discard every piece of
        per-request state — block allocator, slot mirrors, paged KV pools
        — and come back empty. ``steps_run`` keeps counting; ``resets``
        counts the episodes for /healthz."""
        self.alloc = kvc.BlockAllocator(self.cache_cfg)
        if self._index is not None:
            # the pools the cached chains pointed into are gone — a
            # stale index entry would alias zeroed blocks
            self._index = kvc.PrefixIndex(self.cache_cfg.block_size)
        self._kp, self._vp = kvc.init_pools(self.cache_cfg,
                                            self.cfg.compute_dtype,
                                            self.device)
        self._active[:] = False
        self._tables[:] = self.cache_cfg.trash_block
        self._pos[:] = 0
        self._last[:] = 0
        self._temp[:] = 0.0
        self._seed[:] = 0
        self._aidx[:] = 0
        self._reserved.clear()
        self.last_step_finite = True
        self.resets += 1

    # ------------------------------------------------------------ programs --
    def _build_programs(self) -> None:
        cfg, ccfg = self.cfg, self.cache_cfg
        n_layers = cfg.num_layers
        bs, trash = ccfg.block_size, ccfg.trash_block
        sentinel = ccfg.max_blocks_per_slot * bs   # OOB position: drop
        scale = self.bank.scale if self.bank is not None else 1.0
        module, dev = self.module, self.device

        def sample(rows, temps, noise):
            """The single-request step's formula, per row: greedy at
            temp 0, else the Gumbel-max categorical on logits/temp
            (``noise`` from :meth:`_sampling`)."""
            greedy = rows.argmax(-1).int()
            if noise is None:
                return greedy
            sampled = (rows / temps.clamp_min(1e-6)[:, None]
                       + noise).argmax(-1).int()
            return torch.where(temps > 0, sampled, greedy)

        def forward(params, stack, aidx, tokens, q_pos, views):
            adapters = None if stack is None else lora_select(stack, aidx)
            return functional_call(
                module, params, (tokens,),
                {"positions": q_pos, "kv_view": views,
                 "adapters": adapters, "lora_scale": scale})

        def decode_step(params, stack, kp, vp, tables, pos, active, aidx,
                        last_tok, temps, noise):
            views = [(kvc.gather_view(kp[i], tables),
                      kvc.gather_view(vp[i], tables))
                     for i in range(n_layers)]
            q_pos = torch.where(active, pos, sentinel)
            logits, kvs = forward(params, stack, aidx, last_tok[:, None],
                                  q_pos[:, None], views)
            row = logits[:, 0]
            # black-box poison flag: an inactive slot's row may be
            # garbage; only active rows count
            finite = torch.where(active[:, None], torch.isfinite(row),
                                 True).all()
            nxt = sample(row, temps, noise)
            kcs = torch.stack([kc[:, 0] for kc, _ in kvs])   # [L, S, H, D]
            vcs = torch.stack([vc[:, 0] for _, vc in kvs])
            return nxt, finite, kcs, vcs, row

        def decode_write(kp, vp, tables, pos, active, kcs, vcs):
            for i in range(n_layers):
                kvc.scatter_token(kp, i, tables, pos, kcs[i], active, bs,
                                  trash)
                kvc.scatter_token(vp, i, tables, pos, vcs[i], active, bs,
                                  trash)
            return kp, vp

        def chunk_meta(p0, n_valid, c):
            offs = torch.arange(c, dtype=torch.int32, device=dev)
            if torch.is_tensor(p0):   # [B] rows of a wave
                offs = offs[None, :]
                return p0[:, None] + offs, offs < n_valid[:, None]
            return p0 + offs, offs < n_valid

        def prefill_chunk(params, stack, kp, vp, table_row, tokens, p0,
                          n_valid, aidx):
            positions, valid = chunk_meta(p0, n_valid, tokens.shape[0])
            q_pos = torch.where(valid, positions, sentinel)
            views = [(kvc.gather_view(kp[i], table_row[None]),
                      kvc.gather_view(vp[i], table_row[None]))
                     for i in range(n_layers)]
            # a scalar adapter index: shared 2-D leaves
            logits, kvs = forward(params, stack, aidx, tokens[None],
                                  q_pos[None], views)
            kcs = torch.stack([kc[0] for kc, _ in kvs])   # [L, C, H, D]
            vcs = torch.stack([vc[0] for _, vc in kvs])
            return logits[0], kcs, vcs

        def chunk_write(kp, vp, table_row, p0, n_valid, kcs, vcs):
            positions, valid = chunk_meta(p0, n_valid, kcs.shape[1])
            for i in range(n_layers):
                kvc.scatter_chunk(kp, i, table_row, positions, kcs[i],
                                  valid, bs, trash)
                kvc.scatter_chunk(vp, i, table_row, positions, vcs[i],
                                  valid, bs, trash)
            return kp, vp

        def prefill_wave(params, stack, kp, vp, table_rows, tokens, p0,
                         n_valid, aidx):
            """One pass of B piggybacked prefill chunks (tokens
            ``[B, C]``). Rows with ``n_valid == 0`` write only to the
            trash block and query at the sentinel position."""
            positions, valid = chunk_meta(p0, n_valid, tokens.shape[1])
            q_pos = torch.where(valid, positions, sentinel)
            views = [(kvc.gather_view(kp[i], table_rows),
                      kvc.gather_view(vp[i], table_rows))
                     for i in range(n_layers)]
            logits, kvs = forward(params, stack, aidx, tokens, q_pos,
                                  views)   # per-row 3-D adapter leaves
            kcs = torch.stack([kc for kc, _ in kvs])   # [L, B, C, H, D]
            vcs = torch.stack([vc for _, vc in kvs])
            return logits, kcs, vcs

        def wave_write(kp, vp, table_rows, p0, n_valid, kcs, vcs):
            positions, valid = chunk_meta(p0, n_valid, kcs.shape[2])
            for i in range(n_layers):
                kvc.scatter_chunk_batch(kp, i, table_rows, positions,
                                        kcs[i], valid, bs, trash)
                kvc.scatter_chunk_batch(vp, i, table_rows, positions,
                                        vcs[i], valid, bs, trash)
            return kp, vp

        def cow_read(kp, vp, src, dst, n_rows):
            # admission-time copy-on-write, read half: the partially
            # matched cached block's first n_rows over the destination
            # block's tail — [L, bs, H, D] per pool
            keep = (torch.arange(bs, device=dev) < n_rows)[None, :, None,
                                                           None]
            return (torch.where(keep, kp[:, src], kp[:, dst]),
                    torch.where(keep, vp[:, src], vp[:, dst]))

        def cow_write(kp, vp, dst, mk, mv):
            # write half, in place: the slot owns dst, the source block
            # is never written
            kp[:, dst] = mk
            vp[:, dst] = mv
            return kp, vp

        self._step_fn = decode_step
        self._step_write_fn = decode_write
        self._prefill_fn = prefill_chunk
        self._chunk_write_fn = chunk_write
        self._prefill_wave_fn = prefill_wave
        self._wave_write_fn = wave_write
        self._cow_read_fn = cow_read
        self._cow_write_fn = cow_write
        self._sample_fn = sample

    def _stack(self):
        return self.bank.stack(self.device) if self.bank is not None \
            else None

    # ---------------------------------------------------------- admission --
    def free_slots(self) -> List[int]:
        return [int(i) for i in np.flatnonzero(~self._active)
                if int(i) not in self._reserved]

    def can_admit(self, prompt_len: int, max_new_tokens: int) -> bool:
        if not self.free_slots():
            return False
        total = min(int(prompt_len) + int(max_new_tokens),
                    self.cfg.max_seq_len)
        need = self.cache_cfg.blocks_needed(total)
        budget = self.alloc.free_blocks
        if self._index is not None:
            # cold cached chains are reclaimable space: admission may
            # evict them (begin_admit does), so count them as headroom
            budget += self._index.reclaimable(self.alloc)
        return need <= budget

    def _match_prefix(self, ids: List[int]) -> Tuple[List[int], int]:
        """→ ``(chain, matched_tokens)``: the indexed block chain
        prefixing ``ids`` and the token count actually reused, capped at
        ``len(ids) - 1`` so the last prompt token is always prefilled
        (its logits sample the first generated token). Pure lookup —
        hit/reuse accounting happens in ``begin_admit`` once the
        admission actually commits to the aliasing (a dropped alias or a
        returned-None reservation must not count as reuse)."""
        if self._index is None:
            return [], 0
        chain = self._index.match(ids)
        matched = min(len(chain) * self.cache_cfg.block_size,
                      len(ids) - 1)
        return chain, matched

    def begin_admit(self, prompt_ids, *, adapter_idx: int = 0,
                    temperature: float = 0.0, seed: int = 0,
                    max_new_tokens: int = 64) -> Optional[_PendingAdmit]:
        """Reserve a slot + blocks for one request — prefix-match,
        evict cold cache under pressure, alias matched blocks, run the
        COW copy for a partially matched block — WITHOUT prefilling.
        Returns None when no slot or no reclaimable blocks remain (the
        caller waits); raises on requests that can never be admitted."""
        ids = list(map(int, prompt_ids))
        if not ids:
            raise ValueError("empty prompt")
        if len(ids) >= self.cfg.max_seq_len:
            raise ValueError(
                f"prompt of {len(ids)} tokens >= max_seq_len "
                f"{self.cfg.max_seq_len}")
        free = self.free_slots()
        if not free:
            return None
        slot = free[0]
        total = min(len(ids) + int(max_new_tokens), self.cfg.max_seq_len)
        need_total = self.cache_cfg.blocks_needed(total)
        bs = self.cache_cfg.block_size
        chain, matched = self._match_prefix(ids)
        n_alias = matched // bs
        n_copy = matched - n_alias * bs          # COW rows, 0..bs-1
        need_fresh = need_total - n_alias
        if need_fresh > self.alloc.free_blocks and self._index is not None:
            ev0 = self._index.evictions
            self._index.evict(self.alloc, need_fresh, protect=chain)
            if need_fresh > self.alloc.free_blocks:
                # only the protected (matched) chain is still evictable:
                # give up aliasing so those cold blocks can go too
                chain, matched, n_alias, n_copy = [], 0, 0, 0
                need_fresh = need_total
                self._index.evict(self.alloc, need_fresh)
            obs_metrics.record_llm_prefix_evictions(
                self._index.evictions - ev0)
        if need_fresh > self.alloc.free_blocks:
            return None
        row = self.alloc.alloc(slot, total, shared=chain[:n_alias])
        if n_copy > 0:
            # copy-on-write: the reusable head of the partially matched
            # block moves into the slot's OWN block; the shared source
            # is read, never written
            dst = int(row[n_alias])
            mk, mv = self._dispatch("llm_cow_read", self._cow_read_fn,
                                    self._kp, self._vp,
                                    int(chain[n_alias]), dst, n_copy)
            self._kp, self._vp = self._dispatch(
                "llm_cow_write", self._cow_write_fn, self._kp, self._vp,
                dst, mk, mv)
        self._reserved.add(slot)
        if self._index is not None:
            # account reuse only now — the admission COMMITTED to this
            # aliasing (not on a dropped alias or an abandoned lookup)
            if matched > 0:
                self._index.hits += 1
                self._index.tokens_reused += matched
            else:
                self._index.misses += 1
            obs_metrics.record_llm_prefix_cache(matched,
                                                len(ids) - matched)
            # suffix-cache accounting: fully-aliased blocks whose tokens
            # the engine GENERATED (indexed at a prior slot's release) —
            # a multi-turn follow-up aliasing its own earlier reply
            n_decode = self._index.count_suffix_reuse(chain[:n_alias])
            if n_decode > 0:
                self._index.suffix_hits += 1
                self._index.suffix_tokens_reused += n_decode * bs
                obs_metrics.record_llm_suffix_cache(n_decode * bs)
        else:
            n_decode = 0
        info = {"cached_tokens": matched,
                "novel_tokens": len(ids) - matched,
                "aliased_blocks": n_alias, "cow_rows": n_copy,
                "suffix_tokens": n_decode * bs}
        self.last_admit_info = info
        return _PendingAdmit(slot=slot, row=row, ids=ids,
                             novel_start=matched, aidx=int(adapter_idx),
                             temp=float(temperature),
                             seed=int(seed) & 0x7FFFFFFF, info=info)

    def abort_admit(self, pending: _PendingAdmit) -> None:
        """Unwind one wave member after a failed ``finish_admits``. A
        member the failure caught BEFORE activation just returns its
        reservation; one already activated (sampling for a LATER member
        raised) is released like any finished slot — its prompt blocks
        were fully written and index-inserted, so cached entries stay
        valid under the index's own pin."""
        if self._active[pending.slot]:
            self.release(pending.slot)
        else:
            self.alloc.free(pending.slot)
            self._reserved.discard(pending.slot)

    def finish_admits(self, pendings: Sequence[_PendingAdmit]
                      ) -> List[int]:
        """Prefill the reserved admissions' novel suffixes — piggybacked
        through the batched wave program when enabled and the wave has
        more than one member, else serially — then activate the slots.
        Returns each request's first generated token, in order."""
        pendings = list(pendings)
        if not pendings:
            return []
        if self.prefill_batch > 1 and len(pendings) > 1:
            lasts = self._prefill_piggybacked(pendings)
        else:
            lasts = [self._prefill_serial(p) for p in pendings]
        firsts = []
        for p, logits_row in zip(pendings, lasts):
            first = int(self._dispatch(
                "llm_sample", self._sample_fn, logits_row[None],
                *self._sampling([p.temp], [p.seed], [len(p.ids)]))[0])
            self._activate(p, first)
            firsts.append(first)
        return firsts

    def _prefill_serial(self, p: _PendingAdmit):
        """Chunked prefill of one pending admission's novel suffix →
        the last prompt token's logits row (device tensor)."""
        c = self.prefill_chunk
        row_dev = self._dev(p.row)
        stack = self._stack()
        logits_last = None
        last_valid = 1
        for j in range(p.novel_start, len(p.ids), c):
            chunk = p.ids[j:j + c]
            n_valid = len(chunk)
            toks = self._dev(np.asarray(chunk + [0] * (c - n_valid),
                                        np.int32))
            logits_last, kcs, vcs = self._dispatch(
                "llm_prefill_chunk", self._prefill_fn,
                self.params, stack, self._kp, self._vp, row_dev, toks, j,
                n_valid, p.aidx)
            self._kp, self._vp = self._dispatch(
                "llm_prefill_write", self._chunk_write_fn,
                self._kp, self._vp, row_dev, j, n_valid, kcs, vcs)
            last_valid = n_valid
        return logits_last[last_valid - 1]

    def _prefill_piggybacked(self, pendings: List[_PendingAdmit]):
        """The admission wave's chunks through the ``[B, C]`` program:
        pass j carries every member's j-th novel chunk (exhausted rows
        ride along as zero-valid trash writes), so the wave costs
        ``ceil(longest_novel / C)`` passes instead of the members' sum.
        Returns each member's last-prompt-token logits row."""
        c, b = self.prefill_chunk, self.prefill_batch
        stack = self._stack()
        lasts: List[Any] = [None] * len(pendings)
        for g0 in range(0, len(pendings), b):
            group = pendings[g0:g0 + b]
            rows = np.full((b, self.cache_cfg.max_blocks_per_slot),
                           self.cache_cfg.trash_block, np.int32)
            aidx = np.zeros(b, np.int32)
            counts = []
            for i, p in enumerate(group):
                rows[i] = p.row
                aidx[i] = p.aidx
                counts.append(-(-(len(p.ids) - p.novel_start) // c))
            rows_dev = self._dev(rows)
            aidx_dev = self._dev(aidx).long()
            for j in range(max(counts)):
                toks = np.zeros((b, c), np.int32)
                p0 = np.zeros(b, np.int32)
                n_valid = np.zeros(b, np.int32)
                for i, p in enumerate(group):
                    start = p.novel_start + j * c
                    chunk = p.ids[start:start + c]
                    if not chunk:
                        continue
                    toks[i, :len(chunk)] = chunk
                    p0[i] = start
                    n_valid[i] = len(chunk)
                p0_d, nv_d = self._dev(p0), self._dev(n_valid)
                logits, kcs, vcs = self._dispatch(
                    "llm_prefill_wave", self._prefill_wave_fn,
                    self.params, stack, self._kp, self._vp, rows_dev,
                    self._dev(toks), p0_d, nv_d, aidx_dev)
                self._kp, self._vp = self._dispatch(
                    "llm_wave_write", self._wave_write_fn,
                    self._kp, self._vp, rows_dev, p0_d, nv_d, kcs, vcs)
                for i, p in enumerate(group):
                    if j == counts[i] - 1:
                        lasts[g0 + i] = logits[i, int(n_valid[i]) - 1]
        return lasts

    def _activate(self, p: _PendingAdmit, first: int) -> None:
        slot = p.slot
        self._active[slot] = True
        self._tables[slot] = p.row
        self._pos[slot] = len(p.ids)
        self._last[slot] = first
        self._temp[slot] = p.temp
        self._seed[slot] = p.seed
        self._aidx[slot] = p.aidx
        self._reserved.discard(slot)
        if self._index is not None:
            # now that the prompt's full blocks are completely written
            # (and never rewritten: decode lands past the prompt), they
            # become shareable
            self._index.insert(p.ids, p.row, len(p.ids), self.alloc)

    def admit(self, prompt_ids, *, adapter_idx: int = 0,
              temperature: float = 0.0, seed: int = 0,
              max_new_tokens: int = 64) -> Tuple[int, int]:
        """Prefill one request into the lowest free slot; returns
        ``(slot, first_generated_token)``. Deterministic: the same admit
        sequence always lands in the same slots with the same cache
        layout."""
        pending = self.begin_admit(
            prompt_ids, adapter_idx=adapter_idx, temperature=temperature,
            seed=seed, max_new_tokens=max_new_tokens)
        if pending is None:
            if not self.free_slots():
                raise RuntimeError("no free slot")
            raise RuntimeError(
                f"KV pool exhausted: "
                f"{self.alloc.free_blocks} blocks free")
        try:
            first = self.finish_admits([pending])[0]
        except Exception:
            # a failed prefill must not strand the reservation: the
            # slot and its worst-case block reserve go back to the pool
            self.abort_admit(pending)
            raise
        return pending.slot, first

    def release(self, slot: int, final_ids=None) -> None:
        """Return a slot's blocks to the pool. Under suffix caching the
        caller passes ``final_ids`` — the request's full token chain
        (prompt + generated) — and every fully WRITTEN decode block is
        indexed first, under the same pin discipline as prompt blocks,
        so a follow-up or requeued request aliases the whole
        conversation prefix. The insert must precede the free: ``retain``
        requires a live reference, which the slot still holds here.

        Only positions ``0.._pos[slot]-1`` have KV in the pool (the
        final sampled token was never scattered — the slot retired
        before its next step), so indexing caps at ``_pos[slot]``."""
        slot = int(slot)
        if (self.suffix_cache and self._index is not None
                and final_ids is not None and self._active[slot]):
            n = min(int(self._pos[slot]), len(final_ids))
            if n >= self.cache_cfg.block_size:
                added = self._index.insert(
                    [int(t) for t in final_ids[:n]], self._tables[slot],
                    n, self.alloc, origin="decode")
                if added:
                    obs_metrics.record_llm_suffix_insert(added)
        self.alloc.free(slot)
        self._active[slot] = False
        self._tables[slot] = self.cache_cfg.trash_block

    # --------------------------------------------------------------- step --
    def active_count(self) -> int:
        return int(self._active.sum())

    def step(self) -> Dict[int, int]:
        """One decode step for every active slot → ``{slot: next_token}``.
        Each slot's ``last_tok`` is written into the cache at its position
        and the following token is sampled; positions advance by one.
        Tables, positions, active flags, adapter rows, last tokens and
        temperatures go host → device every step; the tokens and the
        finite flag come back in one read."""
        if not self._active.any():
            return {}
        tables_d = self._dev(self._tables)
        pos_d = self._dev(self._pos)
        active_d = self._dev(self._active)
        temps_d, noise = self._sampling(self._temp, self._seed,
                                        self._pos + 1)
        nxt, finite, kcs, vcs, _ = self._dispatch(
            "llm_decode_step", self._step_fn,
            self.params, self._stack(), self._kp, self._vp,
            tables_d, pos_d, active_d, self._dev(self._aidx).long(),
            self._dev(self._last), temps_d, noise)
        self._kp, self._vp = self._dispatch(
            "llm_decode_write", self._step_write_fn,
            self._kp, self._vp, tables_d, pos_d, active_d, kcs, vcs)
        out_h = torch.cat([nxt, finite[None].int()]).cpu().numpy()
        toks = out_h[:-1]
        self.last_step_finite = bool(out_h[-1])
        self.steps_run += 1
        out: Dict[int, int] = {}
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            self._pos[slot] += 1
            self._last[slot] = toks[slot]
            out[slot] = int(toks[slot])
        return out

    def slot_position(self, slot: int) -> int:
        return int(self._pos[slot])

    # ------------------------------------------------------- observability --
    def kv_pool_stats(self) -> Dict[str, Any]:
        """Paged-pool state for the SLO gauges: used/free blocks, how
        many WORST-CASE (max_seq_len) requests the free list can still
        admit, and internal fragmentation — the reserved-but-unwritten
        fraction of allocated blocks (admission reserves prompt+max_new
        up front, so a short generation strands block tail capacity
        until release)."""
        ccfg = self.cache_cfg
        free = self.alloc.free_blocks
        used = ccfg.num_blocks - free
        per_req = ccfg.blocks_needed(ccfg.max_seq_len)
        written = int(self._pos[self._active].sum()) if used else 0
        reclaimable = 0
        if self._index is not None:
            reclaimable = self._index.reclaimable(self.alloc)
            # index-only cached blocks are FULL by construction (only
            # completely written prompt blocks are indexed) — without
            # this an idle pool holding a warm cache reads as 100%
            # fragmented
            written += reclaimable * ccfg.block_size
        capacity = used * ccfg.block_size
        # aliasing REDUCES fragmentation: two slots reading one physical
        # block count their positions against a single block's capacity
        # (clamped at 0 when sharing overshoots)
        frag = 1.0 - written / capacity if capacity else 0.0
        # headroom counts reclaimable cache blocks as free: admission
        # evicts refcount-0 cached blocks on demand, so a full-but-warm
        # pool can still admit. Counting only the free list makes a
        # replica look MORE loaded the warmer its cache gets, and a
        # cache-aware gateway would spill away from exactly the
        # replicas it tried to keep warm.
        return {"used_blocks": used, "free_blocks": free,
                "headroom_requests": (free + reclaimable) // per_req,
                "fragmentation": round(max(frag, 0.0), 4),
                "aliased_blocks": self.alloc.aliased_blocks(),
                "cached_blocks": (self._index.cached_blocks
                                  if self._index is not None else 0)}

    def debug_state(self) -> Dict[str, Any]:
        """The slot matrix + block-table summary, host-side mirrors only
        (no device sync) — the ``/debug/state`` payload."""
        slots = []
        for s in range(self.slots):
            row = {"slot": s, "active": bool(self._active[s])}
            if self._active[s]:
                table = self._tables[s]
                owned = table[table != self.cache_cfg.trash_block]
                row.update({
                    "position": int(self._pos[s]),
                    "adapter_idx": int(self._aidx[s]),
                    "temperature": float(self._temp[s]),
                    "blocks": int(owned.size),
                    "aliased_blocks": int(sum(
                        1 for b in owned
                        if self.alloc.refcount(int(b)) >= 2))})
            slots.append(row)
        out = {"slots": slots, "steps_run": int(self.steps_run),
               "resets": int(self.resets),
               "last_step_finite": bool(self.last_step_finite),
               "kv_pool": self.kv_pool_stats(),
               "geometry": {
                   "num_slots": self.slots,
                   "block_size": self.cache_cfg.block_size,
                   "num_blocks": self.cache_cfg.num_blocks,
                   "max_seq_len": self.cfg.max_seq_len,
                   "prefill_chunk": self.prefill_chunk,
                   "prefill_batch": self.prefill_batch,
                   "prefix_cache": self._index is not None,
                   "suffix_cache": self.suffix_cache}}
        if self._index is not None:
            # the live-diagnosis payload an aliasing bug needs: the
            # index's hit/eviction counters plus every allocated block's
            # reference count (>= 2 means shared right now)
            pc = self._index.debug_state()
            pc["block_refcounts"] = {
                str(b): int(c)
                for b, c in sorted(self.alloc.refcounts().items())}
            out["prefix_cache"] = pc
        return out
