"""LLM serving template: a causal-LM predictor and an OpenAI-compatible
chat route (counterpart of ``fedml_tpu/serving/llm_template.py``).

Two serving modes (``mode``):

* ``"single"``: one request at a time, each token through the full
  forward over the padded ``[1, max_seq_len]`` buffer (the bundle's
  ``apply``, LoRA merged, flash attention = the B2 CUDA kernel on the
  card); the sequential baseline;
* ``"batch"``: requests flow through the continuous-batching engine
  (``serving/batch/``) — paged KV cache, one-token decode work per step,
  per-request LoRA adapter selection from a multi-adapter bank, deadline
  eviction.

The chat endpoint speaks ``POST /v1/chat/completions`` with the OpenAI
request/response schema (and SSE streaming with ``stream=True``).
``from_artifact`` / ``serve_chat`` load a served ``save_model`` artifact
(and, in batch mode, an exported adapter directory) the way the launcher
does. Predictors run on CUDA unless built with ``device="cpu"``.
"""

from __future__ import annotations

import logging
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import prng
from ..device import get_device
from . import FedMLInferenceRunner, FedMLPredictor, load_model

logger = logging.getLogger(__name__)

PyTree = Any


class CausalLMPredictor(FedMLPredictor):
    """Serve a fedml_tpu_torch causal LM.

    ``bundle`` is an :class:`~fedml_tpu_torch.llm.federated.LLMBundle`
    (its ``apply`` merges LoRA adapters when present); ``params`` is the
    trainable dict that ``run_federated_llm`` produced (the adapter dict,
    or the full parameters of a full fine-tune). The bundle's module and
    the params move to ``device`` (CUDA unless ``"cpu"``).

    Two serving modes (``llm_serving_mode``):

    * ``"single"`` (default, the original behavior): one request at a
      time through one full-forward step over the padded
      ``[1, max_seq_len]`` buffer;
    * ``"batch"``: requests flow through the continuous-batching engine
      (``serving/batch/``) — paged KV cache, one-token decode work per
      step, per-request LoRA adapter selection from a multi-adapter bank
      (``adapter_bank`` / ``llm_adapter_dir``), deadline eviction.
    """

    def __init__(self, bundle, params: PyTree, tokenizer=None,
                 max_seq_len: Optional[int] = None,
                 temperature: float = 0.0, mode: str = "single",
                 batch_opts: Optional[Dict[str, Any]] = None,
                 adapter_bank=None, stream: bool = False, device=None):
        from ..llm.data import ByteTokenizer

        self.device = get_device(device)
        self.bundle = bundle.to(self.device)
        self.params = {k: torch.as_tensor(v).to(self.device)
                       for k, v in params.items()}
        self.tokenizer = tokenizer or ByteTokenizer()
        self.max_seq_len = int(max_seq_len or bundle.cfg.max_seq_len)
        self.temperature = float(temperature)
        self.mode = str(mode)
        # llm_stream knob: with it OFF a request carrying "stream": true
        # gets the ordinary JSON completion — the wire stays byte-
        # identical to the pre-streaming path
        self.stream_enabled = bool(stream)
        if self.mode not in ("single", "batch"):
            raise ValueError(f"llm_serving_mode {mode!r}: single|batch")

        self._engine = None
        self._bank = adapter_bank
        self._default_aidx = 0
        self._request_timeout_s = float(
            (batch_opts or {}).get("request_timeout_s", 120.0))
        # suffix caching changes how multi-turn chats ENCODE: the
        # follow-up must reproduce the prior request's exact token chain
        # (prompt ++ SEP ++ generated reply) for the generated blocks to
        # alias; knob off keeps the legacy "\n"-joined prompt byte-for-
        # byte
        self._suffix_chat = bool(
            (batch_opts or {}).get("suffix_cache", False))
        if self._suffix_chat:
            # the byte tokenizer's "replace" decode is lossy on invalid
            # UTF-8 (an untrained model emits it freely), which would
            # break encode(decode(ids)) == ids — the equality the whole
            # suffix-alias path rests on. Swap in the round-trip-exact
            # variant; for valid UTF-8 it is byte-identical.
            from ..llm.data import ByteTokenizer, RoundTripByteTokenizer
            if type(self.tokenizer) is ByteTokenizer:
                self.tokenizer = RoundTripByteTokenizer()
        if self.mode == "batch":
            self._build_engine(batch_opts or {})

    def _build_engine(self, opts: Dict[str, Any]) -> None:
        from .batch import AdapterBank, BatchingEngine, DecodeScheduler
        bundle = self.bundle
        if bundle.base_params is not None:
            # LoRA artifact: base model resident, the artifact's adapter
            # registered as "default" so adapter-less requests behave like
            # the single path (modulo factored-vs-merged float paths)
            base = bundle.base_params
            if self._bank is None:
                self._bank = AdapterBank(
                    self.params, alpha=bundle.lora_alpha,
                    capacity=int(opts.get("max_adapters", 64)))
            self._default_aidx = self._bank.add("default", self.params)
        else:
            # full fine-tune artifact: the params ARE the model; a bank
            # only makes sense if the caller supplied one
            base = self.params
            if self._bank is not None:
                self._default_aidx = 0
        scheduler = DecodeScheduler(
            bundle.module, bundle.cfg, base, self._bank,
            slots=int(opts.get("slots", 8)),
            block_size=int(opts.get("block_size", 16)),
            num_blocks=opts.get("num_blocks"),
            prefill_chunk=int(opts.get("prefill_chunk", 32)),
            prefix_cache=bool(opts.get("prefix_cache", False)),
            prefill_batch=int(opts.get("prefill_batch", 0) or 0),
            suffix_cache=bool(opts.get("suffix_cache", False)),
            device=self.device)
        self._engine = BatchingEngine(
            scheduler,
            default_deadline_s=float(opts.get("deadline_s", 0.0)),
            watchdog_s=float(opts.get("watchdog_s", 30.0)),
            flight_records=int(opts.get("flight_records", 256)),
            flight_dir=opts.get("flight_dir"),
            max_resets=int(opts.get("max_resets", 3)),
            reset_window_s=float(opts.get("reset_window_s", 300.0)),
            max_requeues=int(opts.get("max_requeues", 2)),
            preempt_after_s=float(opts.get("preempt_after_s", 0.0)),
            shed_queue_depth=int(opts.get("shed_queue_depth", 0)),
            chaos=opts.get("chaos"))

    @property
    def adapter_bank(self):
        return self._bank

    @property
    def engine(self):
        return self._engine

    def health(self) -> Dict[str, Any]:
        """``/healthz`` payload: the engine's watchdog view in batch
        mode; the single path is stateless, so up == ok."""
        if self._engine is not None:
            return self._engine.health()
        return {"status": "ok", "mode": "single"}

    def debug_state(self) -> Dict[str, Any]:
        if self._engine is not None:
            return self._engine.debug_state()
        return {"mode": "single", "max_seq_len": self.max_seq_len}

    def close(self) -> None:
        if self._bank is not None and hasattr(self._bank, "stop_watch"):
            self._bank.stop_watch()
        if self._engine is not None:
            self._engine.stop()
            self._engine = None

    @classmethod
    def from_artifact(cls, args, params_path: str, **kw):
        """Load a served artifact the way the launcher does: rebuild the
        bundle from config (model only, no dataset; the base drawn from
        ``random_seed``), params from the msgpack artifact (the JAX
        package's or the port's). ``llm_serving_mode: batch`` turns on
        continuous batching with the ``serving_*`` options;
        ``llm_adapter_dir`` loads a named adapter bank exported by
        ``llm/federated.py`` and ``llm_adapter_watch_s > 0`` watches it
        for hot-swaps; a live ``chaos_serving_*`` knob gives the engine a
        :class:`~fedml_tpu_torch.core.chaos.ServingChaosInjector`.
        ``device`` rides in ``kw``."""
        from ..core.distributed.communication.message import \
            array_to_tensor
        from ..interop import flax_to_state_dict
        from ..llm.federated import build_llm_bundle
        from ..runner import check_ported
        check_ported(args)
        bundle, tokenizer = build_llm_bundle(args)
        kw.setdefault("mode", str(getattr(args, "llm_serving_mode",
                                          "single")))
        if kw["mode"] == "batch":
            kw.setdefault("batch_opts", {
                "slots": int(getattr(args, "serving_slots", 8)),
                "block_size": int(getattr(args, "serving_kv_block_size",
                                          16)),
                "prefill_chunk": int(getattr(args, "serving_prefill_chunk",
                                             32)),
                "max_adapters": int(getattr(args, "serving_max_adapters",
                                            64)),
                "deadline_s": float(getattr(args, "serving_deadline_s",
                                            0.0)),
                "request_timeout_s": float(
                    getattr(args, "serving_request_timeout_s", 120.0)),
                "watchdog_s": float(getattr(args, "serving_watchdog_s",
                                            30.0)),
                "flight_records": int(getattr(args,
                                              "serving_flight_records",
                                              256)),
                "flight_dir": (getattr(args, "serving_flight_dir", None)
                               or getattr(args, "log_file_dir", None)),
                "max_resets": int(getattr(args, "serving_max_resets", 3)),
                "reset_window_s": float(
                    getattr(args, "serving_reset_window_s", 300.0)),
                "max_requeues": int(
                    getattr(args, "serving_max_requeues", 2)),
                "preempt_after_s": float(
                    getattr(args, "serving_preempt_after_s", 0.0)),
                "shed_queue_depth": int(
                    getattr(args, "serving_shed_queue_depth", 0)),
                "prefix_cache": bool(
                    getattr(args, "llm_prefix_cache", False)),
                "prefill_batch": int(
                    getattr(args, "llm_prefill_batch", 0) or 0),
                "suffix_cache": bool(
                    getattr(args, "llm_suffix_cache", False)),
            })
            # seeded serving chaos (engine-side stall/NaN injection);
            # None unless a chaos_serving_* knob is live, so the default
            # decode loop never consults a plan
            if kw["batch_opts"].get("chaos") is None:
                from ..core.chaos import ServingChaosInjector
                kw["batch_opts"]["chaos"] = \
                    ServingChaosInjector.from_args(args)
            adapter_dir = getattr(args, "llm_adapter_dir", None)
            if adapter_dir and kw.get("adapter_bank") is None:
                from .batch import AdapterBank
                kw["adapter_bank"] = AdapterBank.from_artifacts(
                    adapter_dir,
                    alpha=float(getattr(args, "lora_alpha", 16.0)),
                    capacity=int(getattr(args, "serving_max_adapters",
                                         64)))
                # adapter hot-swap: watch the export dir so a fresh
                # federated round's adapters go live with zero restart
                watch_s = float(getattr(args, "llm_adapter_watch_s",
                                        0.0) or 0.0)
                if watch_s > 0:
                    kw["adapter_bank"].watch_dir(adapter_dir,
                                                 poll_s=watch_s)
        kw.setdefault("stream", bool(getattr(args, "llm_stream", False)))
        params = {k: array_to_tensor(v) for k, v in
                  flax_to_state_dict(load_model(params_path)).items()}
        return cls(bundle, params, tokenizer=tokenizer, **kw)

    # --- generation ---------------------------------------------------------
    def _encode_prompt(self, prompt: str, max_new_tokens: int) -> List[int]:
        """Tokenize and fit the prompt: keep the TAIL of an over-long
        prompt (the most recent turns — for chat, dropping the head is
        right and dropping the tail is exactly wrong) and reserve room
        for ``max_new_tokens`` of completion."""
        from ..llm.data import BOS, SEP
        ids = [BOS] + self.tokenizer.encode(prompt) + [SEP]
        reserve = max(1, min(int(max_new_tokens), self.max_seq_len - 1))
        budget = max(1, self.max_seq_len - reserve)
        if len(ids) > budget:
            ids = ids[-budget:]
        return ids

    def _encode_chat(self, messages, max_new_tokens: int) -> List[int]:
        """Suffix-cache chat encoding: assistant turns ride behind a
        ``SEP`` (instruction ++ SEP ++ response — the shape the engine's
        own decode wrote into the KV pool), so a follow-up's token chain
        is EXACTLY the prior request's chain ++ the new user turn, and
        the generated-token blocks alias instead of re-prefilling. The
        byte tokenizer encodes per character, so concatenating per-turn
        encodes equals encoding the concatenation — turn-1 requests
        produce the same ids as :meth:`_encode_prompt`."""
        from ..llm.data import BOS, SEP
        ids: List[int] = [BOS]
        first = True
        for m in messages:
            content = m.get("content") if isinstance(m, dict) else None
            if not content:
                continue
            if isinstance(m, dict) and m.get("role") == "assistant":
                ids += [SEP] + self.tokenizer.encode(str(content))
            else:
                ids += self.tokenizer.encode(
                    str(content) if first else "\n" + str(content))
            first = False
        ids.append(SEP)
        reserve = max(1, min(int(max_new_tokens), self.max_seq_len - 1))
        budget = max(1, self.max_seq_len - reserve)
        if len(ids) > budget:
            ids = ids[-budget:]
        return ids

    def generate(self, prompt: str, max_new_tokens: int = 64,
                 temperature: Optional[float] = None,
                 seed: Optional[int] = None,
                 adapter: Optional[str] = None) -> Dict[str, Any]:
        """``seed=None`` (the default) derives a fresh per-request seed,
        so concurrent no-seed users at ``temperature > 0`` get distinct
        samples; an explicit seed reproduces exactly."""
        import os as _os
        temp = self.temperature if temperature is None else float(temperature)
        if seed is None:
            seed = int.from_bytes(_os.urandom(4), "little") & 0x7FFFFFFF
        ids = self._encode_prompt(prompt, max_new_tokens)
        if self._engine is not None:
            return self._generate_batched(ids, max_new_tokens, temp,
                                          int(seed), adapter)
        if adapter is not None:
            raise ValueError(
                "per-request adapter selection needs llm_serving_mode: "
                "batch (the single path serves one merged artifact)")
        return self._generate_single(ids, max_new_tokens, temp, int(seed))

    def _step(self, buf: torch.Tensor, pos: int, temp: float,
              key: np.ndarray) -> int:
        """One token of the single path: the full forward over the padded
        ``[1, L]`` buffer (causal masking makes the tail inert); the logits
        at the last real position decide the next token — greedy at temp
        0, else the Gumbel-max categorical on logits/temp with ``key``."""
        with torch.no_grad():
            logits = self.bundle.apply(self.params, buf)[0, pos - 1]
            if temp > 0:
                noise = torch.from_numpy(prng.gumbel(
                    key, logits.shape[-1])).to(self.device)
                # a 1-element tensor, not a Python scalar: torch divides
                # by a scalar as a product with its reciprocal on the card
                t = torch.full((1,), max(temp, 1e-6), dtype=torch.float32,
                               device=self.device)
                logits = logits / t + noise
            return int(logits.argmax())

    def _generate_single(self, ids: List[int], max_new_tokens: int,
                         temp: float, seed: int) -> Dict[str, Any]:
        from ..llm.data import EOS
        n_prompt = len(ids)
        buf = torch.zeros((1, self.max_seq_len), dtype=torch.int32,
                          device=self.device)
        buf[0, :n_prompt] = torch.tensor(ids, dtype=torch.int32)
        key = prng.PRNGKey(seed)
        pos = n_prompt
        out_ids: List[int] = []
        finish = "length"
        for _ in range(int(max_new_tokens)):
            if pos >= self.max_seq_len:
                break
            key, sub = prng.split(key)
            nxt = self._step(buf, pos, temp, sub)
            if nxt == EOS:
                finish = "stop"
                break
            out_ids.append(nxt)
            buf[0, pos] = nxt
            pos += 1
        return {"text": self.tokenizer.decode(out_ids),
                "finish_reason": finish,
                "prompt_tokens": n_prompt,
                "completion_tokens": len(out_ids)}

    def _resolve_aidx(self, adapter: Optional[str]) -> Tuple[int, bool]:
        """Adapter name → ``(bank row index, pinned)`` — the ONE
        resolution path for batched and streamed requests. Resolution
        and pinning happen atomically (:meth:`AdapterBank.acquire`), so
        a concurrent hot-swap can never retire-and-reuse the row between
        lookup and submit; the pin transfers to the engine request
        (released at resolution) via ``adapter_pre_pinned``."""
        if adapter is not None and self._bank is None:
            raise ValueError(
                f"adapter {adapter!r} requested but no adapter bank is "
                "loaded (full fine-tune artifact without llm_adapter_dir)")
        pinned = False
        if adapter is not None:
            aidx = self._bank.acquire(adapter)
            pinned = aidx > 0
        else:
            aidx = self._default_aidx
            if self._bank is not None and aidx > 0:
                self._bank.retain_row(aidx)   # fixed idx: no name race
                pinned = True
        from ..core.obs import metrics as obs_metrics
        obs_metrics.record_llm_adapter(
            adapter if adapter is not None
            else ("default" if self._default_aidx else "base"))
        return aidx, pinned

    def _submit_pinned(self, ids: List[int], *, max_new_tokens: int,
                       temp: float, seed: int, adapter: Optional[str],
                       stream_q=None):
        """Resolve+pin the adapter and submit; a submit that raises
        before the engine owns the request releases the pin here."""
        aidx, pinned = self._resolve_aidx(adapter)
        try:
            return self._engine.submit(
                ids, max_new_tokens=int(max_new_tokens),
                temperature=temp, seed=seed, adapter_idx=aidx,
                adapter_pre_pinned=pinned, stream_q=stream_q)
        except Exception:
            if pinned:
                self._bank.release_row(aidx)
            raise

    def _generate_batched(self, ids: List[int], max_new_tokens: int,
                          temp: float, seed: int,
                          adapter: Optional[str]) -> Dict[str, Any]:
        fut = self._submit_pinned(ids, max_new_tokens=max_new_tokens,
                                  temp=temp, seed=seed, adapter=adapter)
        out = fut.result(timeout=self._request_timeout_s)
        return {"text": self.tokenizer.decode(out["ids"]),
                "finish_reason": out["finish_reason"],
                "prompt_tokens": out["prompt_tokens"],
                "completion_tokens": out["completion_tokens"]}

    # --- request surfaces ---------------------------------------------------
    def predict(self, request: Any) -> Any:
        """Plain surface: ``{"prompt": str, "max_new_tokens"?,
        "temperature"?, "seed"?, "adapter"?}`` → ``{"text": ...}``.
        No ``seed`` in the request → a fresh per-request seed (each
        sampled request gets its own stream); an explicit seed is
        reproducible."""
        seed = request.get("seed")
        out = self.generate(
            str(request.get("prompt", "")),
            max_new_tokens=int(request.get("max_new_tokens", 64)),
            temperature=request.get("temperature"),
            seed=None if seed is None else int(seed),
            adapter=request.get("adapter"))
        return out

    def _resolve_adapter(self, request: Any) -> Optional[str]:
        """Explicit ``adapter`` wins; otherwise an OpenAI ``model`` field
        naming a bank entry selects it — existing OpenAI clients pick
        their federated per-silo personalization by model name."""
        adapter = request.get("adapter")
        if adapter is not None:
            return str(adapter)
        model = request.get("model")
        if (model is not None and self._bank is not None
                and self._bank.has(str(model))):
            return str(model)
        return None

    def chat(self, request: Any) -> Any:
        """OpenAI ``/v1/chat/completions`` schema. The prompt is the
        concatenated user/system turns (the instruction-tuning format the
        federated fine-tune trained on: instruction ++ SEP ++ response).
        With the ``llm_stream`` knob on, a request carrying ``"stream":
        true`` returns ``text/event-stream`` chunk deltas instead (knob
        off ⇒ the stream flag is ignored and the wire is byte-identical
        to the pre-streaming path)."""
        messages = request.get("messages") or []
        # keep EVERY turn (assistant replies included) — dropping the
        # model's own prior turns would make multi-turn continuations
        # incoherent
        prompt = "\n".join(str(m.get("content", "")) for m in messages
                           if m.get("content"))
        seed = request.get("seed")
        max_new = int(request.get("max_tokens", 64))
        # suffix-cache encoding (knob-gated): token-level chat layout so
        # follow-ups alias their own generated turns; knob off keeps the
        # legacy string prompt byte-identical
        use_suffix = self._suffix_chat and self._engine is not None
        ids = self._encode_chat(messages, max_new) if use_suffix else None
        if (self.stream_enabled and request.get("stream")
                and self._engine is not None):
            return self._chat_stream(request, prompt, seed, ids=ids)
        if use_suffix:
            import os as _os
            temp = (self.temperature
                    if request.get("temperature") is None
                    else float(request.get("temperature")))
            rseed = (int.from_bytes(_os.urandom(4), "little") & 0x7FFFFFFF
                     if seed is None else int(seed))
            out = self._generate_batched(ids, max_new, temp, rseed,
                                         self._resolve_adapter(request))
        else:
            out = self.generate(
                prompt,
                max_new_tokens=max_new,
                temperature=request.get("temperature"),
                seed=None if seed is None else int(seed),
                adapter=self._resolve_adapter(request))
        # OpenAI's finish_reason enum has no server-side eviction values:
        # "stop" stays "stop", every server-cut reason ("length",
        # "deadline", "preempted") maps to "length" for client compat,
        # with the native reason preserved in finish_reason_detail so a
        # caller can tell "budget spent" from "truncated by the server"
        native = out["finish_reason"]
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": int(time.time()),
            "model": str(request.get("model", self.bundle.name)),
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": out["text"]},
                "finish_reason": "stop" if native == "stop" else "length",
                "finish_reason_detail": native,
            }],
            "usage": {
                "prompt_tokens": out["prompt_tokens"],
                "completion_tokens": out["completion_tokens"],
                "total_tokens": out["prompt_tokens"]
                + out["completion_tokens"],
            },
        }

    def _chat_stream(self, request: Any, prompt: str, seed,
                     ids: Optional[List[int]] = None) -> Any:
        """SSE token streaming: submit with a stream queue and emit one
        OpenAI ``chat.completion.chunk`` per decoded text delta, closed
        by a finish frame carrying ``finish_reason`` +
        ``finish_reason_detail`` and the usage totals. An engine
        preempt/requeue (engine recovery) replays transparently
        mid-stream — the kept prefix is never re-emitted, the stream
        just pauses over the recompute gap."""
        import os as _os
        import queue as _queue

        from . import SSEStream
        from ..core.obs import metrics as obs_metrics

        temp = (self.temperature if request.get("temperature") is None
                else float(request.get("temperature")))
        if seed is None:
            seed = int.from_bytes(_os.urandom(4), "little") & 0x7FFFFFFF
        max_new = int(request.get("max_tokens", 64))
        obs_metrics.record_llm_stream_request()
        if ids is None:
            ids = self._encode_prompt(prompt, max_new)
        q: "_queue.SimpleQueue" = _queue.SimpleQueue()
        # submit BEFORE returning the stream: an Overloaded/validation
        # verdict still surfaces as the ordinary HTTP error, not a
        # broken half-stream
        fut = self._submit_pinned(ids, max_new_tokens=max_new,
                                  temp=temp, seed=int(seed),
                                  adapter=self._resolve_adapter(request),
                                  stream_q=q)
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = str(request.get("model", self.bundle.name))
        deadline = time.time() + self._request_timeout_s

        def chunk(delta: Dict[str, Any], finish=None, **extra):
            out = {"id": rid, "object": "chat.completion.chunk",
                   "created": created, "model": model,
                   "choices": [{"index": 0, "delta": delta,
                                "finish_reason": finish}]}
            out["choices"][0].update(extra)
            return out

        def events():
            yield chunk({"role": "assistant", "content": ""})
            toks: List[int] = []
            emitted = ""
            while True:
                try:
                    kind, val = q.get(
                        timeout=max(deadline - time.time(), 0.001))
                except _queue.Empty:
                    raise TimeoutError(
                        f"stream stalled past request_timeout_s "
                        f"{self._request_timeout_s}")
                if kind == "token":
                    toks.append(int(val))
                    if self._suffix_chat:
                        # per-token deltas: the full-redecode slicing
                        # below silently drops bytes whenever a multi-
                        # byte sequence resolves retroactively (text
                        # changes without growing), so the client's
                        # concatenated reply would not re-encode to the
                        # generated ids. One token -> one lossless delta
                        # keeps the follow-up's re-encode exact.
                        delta = self.tokenizer.decode([int(val)])
                    else:
                        text = self.tokenizer.decode(toks)
                        delta = text[len(emitted):]
                        if delta:
                            emitted = text
                    if delta:
                        yield chunk({"content": delta})
                elif kind == "finish":
                    native = str(val)
                    out = fut.result(timeout=5.0)
                    yield chunk(
                        {}, finish="stop" if native == "stop"
                        else "length",
                        finish_reason_detail=native,
                        usage={
                            "prompt_tokens": out["prompt_tokens"],
                            "completion_tokens":
                                out["completion_tokens"],
                            "total_tokens": out["prompt_tokens"]
                            + out["completion_tokens"]})
                    return
                else:   # ("error", msg)
                    raise RuntimeError(f"stream failed: {val}")

        return SSEStream(events())


class ChatCompletionRunner(FedMLInferenceRunner):
    """Inference runner with the OpenAI chat route mounted:
    ``POST /v1/chat/completions`` (and ``/predict`` + ``/ready`` from the
    base runner); ``chaos`` is the base runner's crash-at-request
    injector."""

    def __init__(self, predictor: CausalLMPredictor, host: str = "127.0.0.1",
                 port: int = 0, chaos=None):
        super().__init__(predictor, host=host, port=port,
                         extra_routes={
                             "/v1/chat/completions": predictor.chat},
                         chaos=chaos)


def serve_chat(args, params_path: str, host: str = "127.0.0.1",
               port: int = 0, block: bool = False,
               device=None) -> ChatCompletionRunner:
    """Two-line path from a federated LoRA artifact to a chat endpoint on
    ``device`` (CUDA unless ``"cpu"``)."""
    predictor = CausalLMPredictor.from_artifact(args, params_path,
                                                device=device)
    runner = ChatCompletionRunner(predictor, host=host, port=port)
    if block:
        runner.run()
    else:
        runner.start()
    return runner
