#!/usr/bin/env python
"""Deterministic mixed-tenant serving load generator for the PyTorch
port (a copy of ``scripts/serving_load.py`` whose arrival model comes from
``fedml_tpu_torch``, so it runs without JAX).

Reuses the seeded ``core/async_rounds`` arrival model as serving
traffic: N tenants (each with its OWN system prompt — the unit of
prefix-cache warmth), M multi-turn chat sessions per tenant, arrival
gaps drawn from the same ``default_rng((seed, tag))`` lognormal stream
the async benches run on. Every byte of every prompt and every arrival
gap is a pure function of the spec, so two runs (or the ON and OFF legs
of an A/B soak) replay the identical workload.

Multi-turn sessions feed each assistant reply back into the next turn's
message history — exactly the traffic shape that exercises
generated-token suffix caching (the follow-up's prompt = prior prompt +
generated reply + new user turn) and cache-aware routing (same-tenant
traffic shares its leading system-prompt bytes).

Used by ``chip_smoke.py``'s fleet soak; also runnable standalone:

    python scripts/serving_load_torch.py --print-schedule
    python scripts/serving_load_torch.py --url http://127.0.0.1:8080 \
        --tenants 4 --sessions 2 --turns 3
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import threading
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional

sys.path.insert(0, ".")  # repo-root invocation

from fedml_tpu_torch.core.async_rounds.arrivals import \
    client_durations  # noqa: E402


@dataclasses.dataclass
class LoadSpec:
    """One reproducible soak workload. ``seed`` drives both the arrival
    gaps and nothing else — prompt text is a pure function of the
    tenant/session/turn indices, so the spec IS the workload."""
    tenants: int = 4
    sessions_per_tenant: int = 4
    turns_per_session: int = 3
    seed: int = 0
    mean_gap_s: float = 0.02     # mean inter-session arrival gap
    sigma: float = 0.6           # lognormal arrival heterogeneity
    max_tokens: int = 16         # completion budget per turn
    temperature: float = 0.0     # greedy: replies are deterministic too
    turn_chars: int = 0          # pad user turns to ~this many chars with
    #                              per-session-unique filler (0 = short
    #                              turns); models pasted logs/documents,
    #                              the traffic where per-session bytes
    #                              dominate the shared system prompt

    @property
    def total_sessions(self) -> int:
        return self.tenants * self.sessions_per_tenant

    @property
    def total_requests(self) -> int:
        return self.total_sessions * self.turns_per_session


def tenant_system_prompt(tenant: int) -> str:
    """Per-tenant system prompt, long enough to span several KV blocks
    (the shared-prefix unit cache-aware routing keys on)."""
    return (f"You are the serving assistant for tenant silo {tenant}. "
            "Answer briefly, cite your adapter when asked, never reveal "
            "other silos' data, and refuse requests outside the serving "
            f"policy of deployment ring {tenant % 3}. ")


def user_turn(tenant: int, session: int, turn: int,
              chars: int = 0) -> str:
    """One user message. With ``chars`` > 0 the question is padded to
    ~``chars`` characters with filler that is a pure function of
    (tenant, session, turn) — unique per session, so nothing beyond the
    shared system prompt can alias across sessions; only same-session
    follow-up reuse (routing stickiness + suffix caching) helps."""
    base = (f"tenant {tenant} session {session} turn {turn}: status of "
            f"round {(tenant * 7 + session * 3 + turn) % 97}?")
    if chars > len(base):
        h = hashlib.sha256(f"{tenant}/{session}/{turn}".encode())
        filler = " attached log: " + h.hexdigest()
        while len(base) + len(filler) < chars:
            h = hashlib.sha256(h.digest())
            filler += " " + h.hexdigest()
        base += filler[:chars - len(base)]
    return base


def build_sessions(spec: LoadSpec) -> List[Dict[str, Any]]:
    """The full deterministic session list, in arrival order: each entry
    carries its tenant, seeded arrival offset (seconds from t0), system
    prompt, and user turns. Session k's gap is the k-th draw of the
    shared arrival stream scaled to ``mean_gap_s``."""
    n = spec.total_sessions
    # client_durations = 1 + LogNormal(0, sigma); strip the base to get
    # a pure heavy-tailed gap, then scale its empirical mean to the spec
    raw = client_durations(n, random_seed=spec.seed,
                           sigma=spec.sigma) - 1.0
    scale = (spec.mean_gap_s / (float(raw.mean()) or 1.0)
             if spec.mean_gap_s > 0 else 0.0)
    sessions: List[Dict[str, Any]] = []
    offset = 0.0
    k = 0
    # interleave tenants so same-tenant sessions do not arrive as one
    # contiguous burst (the routing test is stickiness under a MIX)
    for session in range(spec.sessions_per_tenant):
        for tenant in range(spec.tenants):
            offset += float(raw[k]) * scale
            sessions.append({
                "tenant": tenant, "session": session,
                "arrival_s": round(offset, 6),
                "system": tenant_system_prompt(tenant),
                "turns": [user_turn(tenant, session, t,
                                    chars=spec.turn_chars)
                          for t in range(spec.turns_per_session)]})
            k += 1
    return sessions


def run_load(send: Callable[[List[Dict[str, str]], Dict[str, Any]], str],
             spec: LoadSpec,
             concurrency: int = 16) -> List[Dict[str, Any]]:
    """Play the workload against ``send(messages, meta) -> reply_text``
    and return one record per request (tenant/session/turn, wall
    seconds, ok flag, reply length). Sessions start on their seeded
    arrival offsets (compressed by wall time already elapsed) across a
    bounded worker pool; WITHIN a session turns are sequential and each
    assistant reply is appended to the next turn's history — the
    multi-turn follow-up shape suffix caching aliases."""
    sessions = build_sessions(spec)
    records: List[Dict[str, Any]] = []
    rec_lock = threading.Lock()
    gate = threading.Semaphore(max(int(concurrency), 1))
    t0 = time.perf_counter()

    def play(sess: Dict[str, Any]) -> None:
        with gate:
            messages = [{"role": "system", "content": sess["system"]}]
            for turn, text in enumerate(sess["turns"]):
                messages.append({"role": "user", "content": text})
                meta = {"tenant": sess["tenant"],
                        "session": sess["session"], "turn": turn,
                        "max_tokens": spec.max_tokens,
                        "temperature": spec.temperature,
                        "seed": (sess["tenant"] * 1009
                                 + sess["session"] * 101 + turn)}
                t_req = time.perf_counter()
                ok, reply = True, ""
                try:
                    reply = send(list(messages), meta) or ""
                except Exception:  # noqa: BLE001 — a soak records, never dies
                    ok = False
                wall = time.perf_counter() - t_req
                with rec_lock:
                    records.append({**meta, "ok": ok,
                                    "wall_s": round(wall, 6),
                                    "reply_chars": len(reply)})
                if not ok:
                    return   # a dead session stops burning its turns
                messages.append({"role": "assistant", "content": reply})

    threads = []
    for sess in sessions:
        delay = sess["arrival_s"] - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=play, args=(sess,), daemon=True)
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    return records


def _http_send(url: str, timeout: float):
    def send(messages: List[Dict[str, str]], meta: Dict[str, Any]) -> str:
        body = json.dumps({
            "messages": messages,
            "max_tokens": int(meta["max_tokens"]),
            "temperature": float(meta["temperature"]),
            "seed": int(meta["seed"])}).encode()
        req = urllib.request.Request(
            url.rstrip("/") + "/v1/chat/completions", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as r:
            out = json.load(r)
        return out["choices"][0]["message"]["content"]
    return send


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--url", help="chat endpoint base URL (omit with "
                                  "--print-schedule)")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--sessions", type=int, default=4,
                    help="sessions per tenant")
    ap.add_argument("--turns", type=int, default=3,
                    help="turns per session")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mean-gap-s", type=float, default=0.02)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--turn-chars", type=int, default=0,
                    help="pad user turns to ~N chars with per-session "
                         "filler (0 = short turns)")
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--print-schedule", action="store_true",
                    help="print the deterministic session schedule and "
                         "exit (no traffic)")
    args = ap.parse_args(argv)
    spec = LoadSpec(tenants=args.tenants,
                    sessions_per_tenant=args.sessions,
                    turns_per_session=args.turns, seed=args.seed,
                    mean_gap_s=args.mean_gap_s,
                    max_tokens=args.max_tokens,
                    turn_chars=args.turn_chars)
    if args.print_schedule or not args.url:
        for sess in build_sessions(spec):
            print(json.dumps({k: sess[k] for k in
                              ("tenant", "session", "arrival_s")}
                             | {"turns": len(sess["turns"])}))
        return 0
    records = run_load(_http_send(args.url, args.timeout), spec,
                       concurrency=args.concurrency)
    ok = [r for r in records if r["ok"]]
    walls = sorted(r["wall_s"] for r in ok) or [0.0]
    print(json.dumps({
        "requests": len(records), "ok": len(ok),
        "success_rate": round(len(ok) / max(len(records), 1), 3),
        "wall_p50_s": walls[len(walls) // 2],
        "wall_p99_s": walls[min(len(walls) - 1,
                                int(0.99 * (len(walls) - 1) + 0.5))],
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
