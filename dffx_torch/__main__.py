"""``python -m dffx_torch`` — one front door to every command line of the port.

The same subcommands as ``python -m dffx``, routed to the port's modules (the
direct module paths keep working):

    python -m dffx_torch eval --dataset DDFF ...   # dffx_torch.eval.test
    python -m dffx_torch real-scenes ...           # dffx_torch.eval.real_scenes
    python -m dffx_torch train --recipe DDFF ...   # dffx_torch.train.cli
    python -m dffx_torch simulate ...              # dffx_torch.sim.simulator
    python -m dffx_torch doctor                    # environment report
    python -m dffx_torch --version

Dispatch imports the chosen subcommand lazily, so ``doctor`` can still run
(and report) when an optional dependency of another subcommand is broken.
Exit codes: 0 for the usage and ``--version``, 2 for an unknown command, else
the subcommand's own.
"""

from __future__ import annotations

import sys

_COMMANDS = {
    "eval": ("dffx_torch.eval.test", "benchmark-dataset evaluation (reference test.py)"),
    "real-scenes": ("dffx_torch.eval.real_scenes", "E2E alignment+depth on real captures"),
    "train": ("dffx_torch.train.cli", "training driver (all five recipes + Simulated)"),
    "simulate": ("dffx_torch.sim.simulator", "thin-lens focal-stack simulator (NYU-v2)"),
    "doctor": ("dffx_torch.utils.doctor", "environment / install health report"),
}


def _usage() -> str:
    import dffx_torch

    lines = [f"dffx_torch {dffx_torch.__version__} — depth from focus on the GPU "
             "(PyTorch + CUDA)", "",
             "usage: python -m dffx_torch <command> [args...]", "", "commands:"]
    for name, (_, help_) in _COMMANDS.items():
        lines.append(f"  {name:<12} {help_}")
    lines.append("")
    lines.append("`python -m dffx_torch <command> --help` shows that command's flags.")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    if argv[0] in ("--version", "version"):
        import dffx_torch

        print(f"dffx_torch {dffx_torch.__version__}")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in _COMMANDS:
        print(f"unknown command: {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    import importlib

    mod = importlib.import_module(_COMMANDS[cmd][0])
    rc = mod.main(rest)
    return 0 if rc is None else int(rc)


if __name__ == "__main__":
    raise SystemExit(main())
