"""Cross-silo runner dispatch (counterpart of
``fedml_tpu/cross_silo/runner.py``): the horizontal scenario; the
hierarchical one is not ported yet."""

from __future__ import annotations


def build_cross_silo_runner(args, dataset, model, client_trainer=None,
                            server_aggregator=None, *, device,
                            init_params=None):
    scenario = str(getattr(args, "scenario", "horizontal")).lower()
    if scenario == "hierarchical":
        raise NotImplementedError(
            "scenario: hierarchical (cross_silo/hierarchical) is not ported "
            "to fedml_tpu_torch yet (ported: scenario horizontal)")
    from .horizontal.runner import CrossSiloRunner
    return CrossSiloRunner(args, dataset, model, client_trainer,
                           server_aggregator, device=device,
                           init_params=init_params)
