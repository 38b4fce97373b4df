"""``iridectl``-style live status: render the telemetry snapshot file.

A server launched with ``--telemetry-snapshot /tmp/irid.json`` writes an
atomic JSON snapshot of its live specialization state on an interval
(:class:`~repro_torch.core.telemetry.SnapshotWriter`); this CLI renders it::

    python -m repro_torch.launch.status /tmp/irid.json            # one shot
    python -m repro_torch.launch.status /tmp/irid.json --watch    # live refresh

Shown per context: lifecycle phase, the active (and canary/pending)
config, the goodput window, and the safety stage; plus the compile
queue, the serve queue, quarantine totals, and flight-recorder bus
health.  The snapshot is written via tmp+rename, so reading it here
never races a torn file — worst case the file does not exist yet.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

__all__ = ["render", "main"]


def _cfg_str(cfg, limit: int = 48) -> str:
    if not cfg:
        return "-"
    if isinstance(cfg, str):
        s = cfg
    else:
        s = ",".join(f"{k}={v}" for k, v in sorted(
            cfg.items(), key=lambda kv: str(kv[0])))
    return s if len(s) <= limit else s[:limit - 1] + "…"


def _num(x, nd: int = 1) -> str:
    if x is None:
        return "-"
    try:
        f = float(x)
    except (TypeError, ValueError):
        return str(x)
    return f"{f:.{nd}f}" if math.isfinite(f) else "-"


def _table(rows: list[list[str]], header: list[str]) -> list[str]:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*(str(c) for c in row)) for row in rows]
    return lines


def render(doc: dict, now: float | None = None) -> str:
    """Render one snapshot dict as the status screen (pure: testable)."""
    now = time.time() if now is None else now
    lines: list[str] = []
    age = (f"{max(0.0, now - doc['written_at']):.1f}s ago"
           if "written_at" in doc else "?")
    mode = doc.get("mode", "?")
    head = f"iridescent status  [{mode}]  snapshot {age}"
    if doc.get("handler"):
        head += f"  handler={doc['handler']}"
    lines.append(head)

    bus = doc.get("bus")
    if bus:
        lines.append(f"bus: emitted={bus.get('emitted')} "
                     f"dropped={bus.get('dropped_events')} "
                     f"retained={bus.get('retained')}")
    comp = doc.get("compile")
    if comp:
        lines.append(
            f"compile: queued={comp.get('queue_depth', '-')} "
            f"in_flight={comp.get('in_flight', '-')} "
            f"hit_rate={_num(comp.get('cache_hit_rate'), 3)} "
            f"build_p50_s={_num(comp.get('build_p50_s'), 4)}")
    q = doc.get("queue")
    if q:
        lines.append(f"queue: waiting={q.get('waiting')} "
                     f"in_flight={q.get('in_flight')}")
    serve = doc.get("serve")
    if serve:
        lines.append(
            f"serve: completed={serve.get('completed')} "
            f"shed={serve.get('shed')} "
            f"goodput_tokens={serve.get('goodput_tokens')} "
            f"p95_ms={_num(serve.get('latency_p95_ms'))}")

    if mode == "fleet":
        reps = doc.get("replicas") or {}
        rows = [[name, str(st.get("depth", "-"))]
                for name, st in sorted(reps.items())]
        if rows:
            lines.append("")
            lines += _table(rows, ["replica", "depth"])
        router = doc.get("router")
        if router:
            lines.append(f"router: {json.dumps(router)}")
        return "\n".join(lines)

    safety = doc.get("safety") or {}
    safe_ctx = safety.get("contexts") or {}
    contexts = doc.get("contexts") or {}
    if contexts:
        rows = []
        for key in sorted(contexts):
            st = contexts[key]
            # safety_status keys contexts by *encoded* key; match loosely
            # by position-independent lookup over both spellings.
            sst = safe_ctx.get(key) or next(
                (v for k, v in safe_ctx.items() if k in key or key in k), {})
            win = st.get("tput_window") or {}
            rows.append([
                key,
                st.get("phase", "?"),
                sst.get("stage", "-"),
                _cfg_str(st.get("active")),
                _cfg_str(st.get("pending")) if st.get("phase") != "exploit"
                else "-",
                _num(win.get("rate") or win.get("calls_per_s")
                     or st.get("best_metric")),
                str(len(sst.get("quarantined") or [])),
            ])
        lines.append("")
        lines += _table(rows, ["context", "phase", "stage", "active",
                               "candidate", "goodput", "quar"])
    if safety:
        lines.append(
            f"safety: promotions={safety.get('promotions')} "
            f"rollbacks={safety.get('rollbacks')} "
            f"shadow_rej={safety.get('shadow_rejections')} "
            f"canary_rej={safety.get('canary_rejections')} "
            f"quarantined={safety.get('quarantined')}")
    return "\n".join(lines)


def _load(path: str) -> dict | None:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None                       # not written yet / mid-replace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("snapshot", help="path written by --telemetry-snapshot")
    ap.add_argument("--watch", action="store_true",
                    help="refresh until interrupted")
    ap.add_argument("--interval-s", type=float, default=1.0)
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="print the raw snapshot JSON instead of the table")
    args = ap.parse_args(argv)
    while True:
        doc = _load(args.snapshot)
        if doc is None:
            out = f"(no snapshot at {args.snapshot} yet)"
        elif args.as_json:
            out = json.dumps(doc, indent=1, sort_keys=True)
        else:
            out = render(doc)
        if args.watch:
            sys.stdout.write("\x1b[2J\x1b[H" + out + "\n")
            sys.stdout.flush()
            try:
                time.sleep(max(0.1, args.interval_s))
            except KeyboardInterrupt:
                return 0
        else:
            print(out)
            return 0 if doc is not None else 1


if __name__ == "__main__":
    sys.exit(main())
