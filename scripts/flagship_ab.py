#!/usr/bin/env python3
"""The flagship phase of one checkout's ``chip_smoke.py``, alone, in this
fresh process, on one CUDA card.

    python3 scripts/flagship_ab.py <checkout> plain|resume_first|scaffold

``<checkout>`` is the root of a checkout (this one, or an older commit
unpacked with ``git archive``); its kernels are built there first.
``resume_first`` runs its phase-5 resume parity check before the flagship
phase, as ``chip_smoke.py`` does; ``scaffold`` runs the same configuration
with SCAFFOLD instead (``chip_smoke.py``'s phase 7 (b)). Prints one JSON
line: rounds/hour, ms per local step, the SP baseline's seconds per round
(FedAvg only), the card, and (checkouts with ``card_state``) the card's SM
clock, power and temperature right after the timed block. Run two
checkouts or two modes in turns (A, B, B, A) in one call to compare them
on one card.
"""
import inspect, json, os, sys, tempfile
root, mode = os.path.abspath(sys.argv[1]), sys.argv[2]
os.chdir(root)
sys.path.insert(0, root)
import torch
import chip_smoke as c
from fedml_tpu_torch.core.kernels import build, conv_block as cb
from fedml_tpu_torch.core.kernels import flash_attention as fa
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
for name in ("conv_block", "flash_attention"):
    build.build(name)
card = c.card_line()
with tempfile.TemporaryDirectory() as tmp:
    if mode == "resume_first":
        c.resume_parity(torch, tmp)
    if mode == "scaffold":
        rec, _ = c.scaffold_flagship(torch, cb, fa)
        rec["value"] = rec["rounds_per_hour"]
    elif "tmp" in inspect.signature(c.flagship).parameters:
        rec, _ = c.flagship(torch, cb, fa, card, tmp)
    else:
        rec, _ = c.flagship(torch, cb, fa, card)
print(json.dumps({"checkout": os.path.basename(root), "mode": mode,
                  "rounds_per_hour": rec["value"],
                  "ms_per_local_step": rec["ms_per_local_step"],
                  "sp_baseline_round_s": rec.get("sp_baseline_round_s"),
                  "card_after_block": rec.get("card_after_block"),
                  "card": card}))
