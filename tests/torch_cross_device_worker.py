"""One role (server or device) of the port's cross-device session over TCP
on loopback, driven through the public ``FedMLRunner`` on the CPU, for
``tests/test_torch_cross_device_multiprocess.py``. A device may run the
native C++ engine: a separate OS process training natively against a
Python server, the reference's MobileNN deployment shape.

Usage: torch_cross_device_worker.py <role> <rank> <base_port> <cache_dir>
                                    <engine> <out>
"""

import json
import sys

import torch


def main() -> None:
    role, rank, base_port, cache_dir, engine, out_path = sys.argv[1:7]
    torch.set_num_threads(1)
    from fedml_tpu_torch import data as data_mod, model as model_mod
    from fedml_tpu_torch.arguments import Arguments
    from fedml_tpu_torch.runner import FedMLRunner

    args = Arguments(
        dataset="digits", model="lr", client_num_in_total=2,
        client_num_per_round=2, comm_round=2, epochs=1, batch_size=32,
        learning_rate=0.2, random_seed=3, training_type="cross_device",
        backend="TCP", tcp_base_port=int(base_port), role=role,
        rank=int(rank), model_file_cache_dir=cache_dir,
        round_timeout_s=30.0,
        device_engine=(engine if engine != "-" else "torch"))
    fed, output_dim = data_mod.load(args)
    bundle = model_mod.create(args, output_dim, fed.input_shape)
    runner = FedMLRunner(args, device="cpu", dataset=fed, model=bundle)
    result = runner.run()

    if role == "server":
        hist = (result or {}).get("history") or []
        manager = runner.runner.manager
        engines = {str(did): d.get("engine")
                   for did, d in manager.devices_online.items()}
        with open(out_path, "w") as f:
            json.dump({"rounds": len(hist),
                       "final_test_acc": (result or {}).get(
                           "final_test_acc"),
                       "engines": engines,
                       "device_eval_accs": [r.get("device_eval_acc")
                                            for r in hist]}, f)


if __name__ == "__main__":
    main()
