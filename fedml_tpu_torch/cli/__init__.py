"""CLI package: ``python -m fedml_tpu_torch.cli <command>`` (counterpart
of ``fedml_tpu/cli``).

Parity target: the reference's click command group ``cli/cli.py:11-77``
(``fedml login/launch/run/build/logs/env/version/diagnosis/...``). Commands
here wrap :mod:`fedml_tpu_torch.api` — the same local-first platform the
Python API exposes — plus ``train`` (run a training config in-process) and
``serve`` (serve a saved model artifact). Built on ``argparse``;
:func:`main` runs one command in-process and returns its exit code.
"""

from .main import build_parser, main  # noqa: F401
