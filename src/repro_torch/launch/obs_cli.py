"""Shared ``--metrics`` / ``--trace-out`` plumbing for the launch CLIs (a
copy of ``repro.launch.obs_cli``).

Both launch CLIs expose the same two flags: ``--metrics [PATH]`` enables
:mod:`repro_torch.obs` and dumps the Prometheus-text metrics at exit (to
PATH, or stdout when the flag is bare), ``--trace-out PATH`` additionally
writes the Chrome-trace/Perfetto span timeline. Usage::

    add_obs_args(ap)
    args = ap.parse_args(argv)
    observing = obs_begin(args)
    try:
        ...
    finally:
        obs_end(args, observing)
"""
from __future__ import annotations

import argparse

from repro_torch import obs


def add_obs_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--metrics", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="enable repro_torch.obs and dump Prometheus-text "
                         "metrics at exit (to PATH, or stdout when bare)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable repro_torch.obs and write a Chrome-trace/"
                         "Perfetto JSON span timeline to PATH at exit")


def obs_begin(args: argparse.Namespace) -> bool:
    """Enable observability when either flag was passed; returns whether."""
    observing = args.metrics is not None or args.trace_out is not None
    if observing:
        obs.reset()
        obs.enable()
    return observing


def obs_end(args: argparse.Namespace, observing: bool) -> None:
    """Disable observability and write/print the requested exports."""
    if not observing:
        return
    obs.disable()
    if args.metrics is not None:
        text = obs.to_prometheus()
        if args.metrics:
            with open(args.metrics, "w") as f:
                f.write(text)
            print(f"# wrote metrics to {args.metrics}")
        else:
            print("# --- metrics (prometheus text) ---")
            print(text, end="")
    if args.trace_out is not None:
        obs.write_trace(args.trace_out)
        print(f"# wrote trace to {args.trace_out}")
