"""Cross-silo runner dispatch (counterpart of
``fedml_tpu/cross_silo/runner.py``): ``scenario: hierarchical`` builds the
hierarchical runner (silos of data-parallel ranks), anything else the
horizontal one."""

from __future__ import annotations


def build_cross_silo_runner(args, dataset, model, client_trainer=None,
                            server_aggregator=None, *, device,
                            init_params=None):
    scenario = str(getattr(args, "scenario", "horizontal")).lower()
    if scenario == "hierarchical":
        from .hierarchical.runner import HierarchicalCrossSiloRunner
        return HierarchicalCrossSiloRunner(
            args, dataset, model, client_trainer, server_aggregator,
            device=device, init_params=init_params)
    from .horizontal.runner import CrossSiloRunner
    return CrossSiloRunner(args, dataset, model, client_trainer,
                           server_aggregator, device=device,
                           init_params=init_params)
