"""CLI for telemetry runs: ``report``, ``trace`` and ``top``
(counterpart of the reference's ``python -m ... telemetry``).

- ``report [--session <id>] [--kind <k>] <run.jsonl>``: the per-op table
  and the event summaries, narrowed to one session or one record kind.
- ``trace [<run.jsonl>] <out.json>``: the run's spans as Chrome-trace /
  Perfetto JSON (``chrome://tracing``, https://ui.perfetto.dev); with one
  argument the input is the ``telemetry.path`` option's file.
- ``top [<snapshot.json>]``: the in-flight queries, from a saved
  ``QueryServer.inspect()`` snapshot (or a list of them), or live from
  this process.
"""

from __future__ import annotations

import json
import sys

from spark_rapids_jni_tpu_torch.telemetry import spans, top
from spark_rapids_jni_tpu_torch.telemetry.report import (
    KINDS,
    load_jsonl,
    report,
)
from spark_rapids_jni_tpu_torch.utils.config import get_option

_USAGE = """\
usage: python -m spark_rapids_jni_tpu_torch.telemetry <command> ...

commands:
  report [--session <id>] [--kind <k>] <run.jsonl>
  trace  [<run.jsonl>] <out.json>
  top    [<snapshot.json>]
"""


def _usage() -> int:
    print(_USAGE, file=sys.stderr)
    return 2


def _report(argv: list[str]) -> int:
    session = kind = None
    paths: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        if arg in ("--session", "--kind"):
            if i + 1 >= len(argv):
                return _usage()
            if arg == "--session":
                session = argv[i + 1]
            else:
                kind = argv[i + 1]
                if kind not in KINDS:
                    print(f"error: unknown kind {kind!r} "
                          f"(expected one of {', '.join(KINDS)})",
                          file=sys.stderr)
                    return 2
            i += 2
        elif arg.startswith("-"):
            return _usage()
        else:
            paths.append(arg)
            i += 1
    if len(paths) != 1:
        return _usage()
    try:
        text = report(paths[0], session=session, kind=kind)
    except OSError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(text)
    return 0


def _trace(argv: list[str]) -> int:
    if len(argv) == 1:
        src, out = str(get_option("telemetry.path")), argv[0]
        if not src:
            print("error: no input given and telemetry.path is unset",
                  file=sys.stderr)
            return 2
    elif len(argv) == 2:
        src, out = argv
    else:
        return _usage()
    try:
        n = spans.write_chrome_trace(load_jsonl(src), out)
    except OSError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(f"wrote {n} span events to {out}")
    return 0


def _top(argv: list[str]) -> int:
    if len(argv) > 1:
        return _usage()
    if argv:
        try:
            with open(argv[0], "r", encoding="utf-8") as fh:
                snapshots = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        print(top.render_top(snapshots))
        return 0
    print(top.render_top(top.collect()))
    return 0


def main(argv: list[str]) -> int:
    if not argv:
        return _usage()
    cmd, rest = argv[0], argv[1:]
    commands = {"report": _report, "trace": _trace, "top": _top}
    if cmd not in commands:
        return _usage()
    return commands[cmd](rest)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
