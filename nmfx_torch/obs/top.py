"""``nmfx-top`` — the live fleet dashboard over a telemetry_dir
(counterpart of ``nmfx/obs/top.py``; ``python -m nmfx_torch.obs.top``
or the ``nmfx-torch-top`` script). Its frames are the reference's, line
for line, so a fleet of either package renders the same way.

The human tail of the fleet observatory: point it at the
``telemetry_dir`` the instances publish into (``ServeConfig
.telemetry_dir``, replica pools, routers) and it
renders, per refresh, the per-instance liveness table (role, pid,
device kind, heartbeat age, queue depth, inflight), the fleet-merged
serving stats (outcome counts, goodput, p50/p99 from the merged
histograms — union-of-observations exact, ``metrics
.bucket_quantile``), the mean MFU per dispatch kind, and the SLO
burn-rate status (``nmfx_torch.obs.slo`` over the fleet snapshot, so the
alert states are the fleet's, not one replica's).

Forms follow the data's job (no charts for chart's sake): identity +
liveness is a table, headline load numbers are stat rows, SLO state is
a status line whose state is NEVER color-alone — each state carries a
symbol + word (``ok`` / ``FAST BURN`` / ``SLOW BURN``), so the
terminal, the ``--html`` static render, a monochrome pipe, and a
screen reader all agree.

Modes: the default loops at ``--interval`` (goodput is the
completed-count delta over the refresh interval); ``--once`` renders a
single frame (rates read ``n/a`` — one frame has no window);
``--html PATH`` writes a static HTML render of the frame and exits.
Stdlib-only, like the rest of ``nmfx_torch.obs``.
"""

from __future__ import annotations

import argparse
import html
import sys
import time

from nmfx_torch.obs import metrics as _metrics
from nmfx_torch.obs import slo as _slo
from nmfx_torch.obs.aggregate import FleetCollector

__all__ = ["gather", "main", "render_html", "render_text"]

#: alert-state presentation: symbol + word, state never color-alone
_STATE_MARK = {"ok": "· ok", "fast_burn": "!! FAST BURN",
               "slow_burn": "! SLOW BURN"}


def _combined_hist(rec: "dict | None") -> "dict | None":
    """Sum one histogram metric's state across ALL its labeled series
    (e.g. every ``outcome``) — the shared ``metrics
    .merge_bucket_state`` arithmetic, so quantiles over the combined
    state stay union-exact."""
    if rec is None or rec.get("type") != "histogram" \
            or not rec["series"]:
        return None
    out = None
    for st in rec["series"].values():
        if out is None:
            out = {"count": st["count"], "sum": st["sum"],
                   "min": st["min"], "max": st["max"],
                   "bucket_counts": list(st["bucket_counts"])}
        else:
            _metrics.merge_bucket_state(out, st)
    return out


def gather(collector: FleetCollector, engine: "_slo.SLOEngine",
           prev: "tuple[float, dict] | None" = None,
           now: "float | None" = None) -> dict:
    """One dashboard frame: instance rows, fleet stats, SLO status.
    ``prev`` is the previous frame's ``(t, fleet_snapshot)`` — rates
    (goodput) are computed over that window; None on the first frame
    (rates render n/a). The instance table and the merged stats derive
    from ONE ledger read, so the frame is a consistent cut (the SLO
    engine's windowed view reads through its own ``snapshot_fn``)."""
    now = time.time() if now is None else now
    payloads = collector.collect()
    snap = collector.fleet_snapshot(now, payloads=payloads)
    rows = collector.instances(now, payloads=payloads)
    gauge_by_instance: "dict[str, dict]" = {}
    for metric, field in (("nmfx_serve_queue_depth", "queue_depth"),
                          ("nmfx_serve_inflight", "inflight")):
        rec = snap.get(metric)
        if rec is None:
            continue
        for key, val in rec["series"].items():
            gauge_by_instance.setdefault(key[0], {})[field] = val
    for row in rows:
        # payload-embedded status (per-instance levels) wins
        # over the process-wide gauges, which N in-process replicas
        # overwrite each other on
        for field, val in gauge_by_instance.get(row["instance"],
                                                {}).items():
            row.setdefault(field, val)
    e2e = snap.get("nmfx_serve_e2e_seconds")
    outcomes: "dict[str, int]" = {}
    if e2e is not None and "outcome" in e2e["labels"]:
        idx = e2e["labels"].index("outcome")
        for key, st in e2e["series"].items():
            outcomes[key[idx]] = outcomes.get(key[idx], 0) + st["count"]
    combined = _combined_hist(e2e)
    p50 = p99 = None
    if combined is not None and e2e is not None:
        p50 = _metrics.bucket_quantile(e2e["buckets"], combined, 0.5)
        p99 = _metrics.bucket_quantile(e2e["buckets"], combined, 0.99)
    goodput = None
    if prev is not None:
        prev_t, prev_snap = prev
        delta = _metrics.snapshot_delta(snap, prev_snap)
        drec = _combined_hist(delta.get("nmfx_serve_e2e_seconds"))
        if drec is not None and now > prev_t:
            goodput = drec["count"] / (now - prev_t)
    mfu = {}
    mrec = snap.get("nmfx_perf_mfu")
    if mrec is not None:
        for key, st in mrec["series"].items():
            if st["count"]:
                mfu[",".join(key) or "all"] = st["sum"] / st["count"]
    # request economics: the result-cache/coalescing/extend
    # counters, fleet-summed across layers (server + router series)
    def _counter_sum(name):
        rec = snap.get(name)
        if rec is None or rec.get("type") != "counter":
            return None
        return sum(rec["series"].values())

    economics = None
    hits = _counter_sum("nmfx_result_cache_hits_total")
    misses = _counter_sum("nmfx_result_cache_misses_total")
    coalesced = _counter_sum("nmfx_result_cache_coalesced_total")
    extended = _counter_sum("nmfx_result_cache_extended_total")
    if any(v is not None
           for v in (hits, misses, coalesced, extended)):
        h, m, c = hits or 0.0, misses or 0.0, coalesced or 0.0
        served = sum(outcomes.values())
        economics = {
            "hits": int(h), "misses": int(m), "coalesced": int(c),
            "extended": int(extended or 0),
            "hit_rate": (h / (h + m)) if (h + m) else None,
            "coalesce_rate": (c / served) if served else None,
        }
    slo_status = engine.evaluate(now)
    return {"t": now, "instances": rows, "outcomes": outcomes,
            "p50_s": p50, "p99_s": p99, "goodput_req_per_s": goodput,
            "mfu": mfu, "economics": economics, "slo": slo_status,
            "snapshot": snap}


def _fmt(v, suffix="", digits=3) -> str:
    if v is None:
        return "n/a"
    return f"{v:.{digits}f}{suffix}"


def _role_summary(rows: "list[dict]") -> str:
    """One line summarizing the fleet BY ROLE: a service
    tier reads as "router 1 live · replica 2 live / 1 stale", so an
    operator sees the front door and its pool distinctly without
    scanning the instance table."""
    by_role: "dict[str, list[bool]]" = {}
    for row in rows:
        by_role.setdefault(str(row.get("role")), []).append(
            bool(row["stale"]))
    parts = []
    for role in sorted(by_role):
        stales = by_role[role]
        live = len(stales) - sum(stales)
        part = f"{role} {live} live"
        if sum(stales):
            part += f" / {sum(stales)} stale"
        parts.append(part)
    return " · ".join(parts)


def render_text(frame: dict, telemetry_dir: str) -> str:
    """The terminal frame — plain text, fixed-width columns."""
    lines = [f"nmfx-top — fleet telemetry from {telemetry_dir}"]
    rows = frame["instances"]
    if not rows:
        lines.append("  (no telemetry instances found — is anything "
                     "publishing here?)")
        return "\n".join(lines) + "\n"
    lines.append("roles: " + _role_summary(rows))
    lines.append(f"{'instance':<34}{'role':<9}{'pid':>7} "
                 f"{'device':<14}{'hb age':>8} {'state':<6}"
                 f"{'queue':>6}{'infl':>6}")
    for row in sorted(rows, key=lambda r: r["instance"]):
        state = "stale" if row["stale"] else "live"
        lines.append(
            f"{row['instance']:<34}{str(row['role']):<9}"
            f"{str(row['pid']):>7} {str(row['device_kind'])[:13]:<14}"
            f"{row['heartbeat_age_s']:>7.1f}s {state:<6}"
            f"{str(row.get('queue_depth', '-')):>6}"
            f"{str(row.get('inflight', '-')):>6}")
    out = frame["outcomes"]
    lines.append("")
    lines.append(
        "serve: "
        + " ".join(f"{k}={int(v)}" for k, v in sorted(out.items()))
        if out else "serve: no requests observed")
    goodput = _fmt(frame["goodput_req_per_s"], " req/s", 2)
    lines.append(f"latency: p50={_fmt(frame['p50_s'], 's')} "
                 f"p99={_fmt(frame['p99_s'], 's')}   "
                 f"goodput={goodput}")
    if frame["mfu"]:
        lines.append("mfu: " + " ".join(
            f"{kind}={val:.3f}"
            for kind, val in sorted(frame["mfu"].items())))
    econ = frame.get("economics")
    if econ is not None:
        lines.append(
            f"economics: hit_rate={_fmt(econ['hit_rate'], '', 2)} "
            f"(hits={econ['hits']} misses={econ['misses']}) "
            f"coalesce_rate={_fmt(econ['coalesce_rate'], '', 2)} "
            f"(coalesced={econ['coalesced']}) "
            f"extended={econ['extended']}")
    slo = frame["slo"]
    for name, obj in sorted(slo["objectives"].items()):
        burns = " ".join(f"{w}={_fmt(b, '', 2)}"
                         for w, b in obj["burn"].items())
        mark = _STATE_MARK.get(obj["state"], obj["state"])
        lines.append(f"slo {name:<14} {mark:<14} burn: {burns}")
    return "\n".join(lines) + "\n"


def render_html(frame: dict, telemetry_dir: str) -> str:
    """A static HTML render of one frame: the same tables and stat
    rows as the terminal (neutral ink, system fonts; SLO states carry
    symbol + word, never color alone)."""
    esc = html.escape

    def chip(state: str) -> str:
        return (f'<span class="chip {esc(state)}">'
                f"{esc(_STATE_MARK.get(state, state))}</span>")

    inst_rows = "".join(
        "<tr><td>{i}</td><td>{r}</td><td class='num'>{p}</td>"
        "<td>{d}</td><td class='num'>{a:.1f}s</td><td>{s}</td>"
        "<td class='num'>{q}</td><td class='num'>{f}</td></tr>".format(
            i=esc(str(row["instance"])), r=esc(str(row["role"])),
            p=esc(str(row["pid"])), d=esc(str(row["device_kind"])),
            a=row["heartbeat_age_s"],
            s="stale" if row["stale"] else "live",
            q=esc(str(row.get("queue_depth", "–"))),
            f=esc(str(row.get("inflight", "–"))))
        for row in sorted(frame["instances"],
                          key=lambda r: r["instance"]))
    outcome_row = " · ".join(
        f"{esc(k)}&nbsp;{int(v)}"
        for k, v in sorted(frame["outcomes"].items())) or "none yet"
    slo_rows = "".join(
        "<tr><td>{n}</td><td>{c}</td><td class='num'>{b}</td></tr>"
        .format(n=esc(name), c=chip(obj["state"]),
                b=esc(" ".join(f"{w}={_fmt(v, '', 2)}"
                               for w, v in obj["burn"].items())))
        for name, obj in sorted(frame["slo"]["objectives"].items()))
    stats = [
        ("p50 latency", _fmt(frame["p50_s"], " s")),
        ("p99 latency", _fmt(frame["p99_s"], " s")),
        ("goodput", _fmt(frame["goodput_req_per_s"], " req/s", 2)),
    ] + [(f"mfu {k}", f"{v:.3f}")
         for k, v in sorted(frame["mfu"].items())]
    if frame.get("economics") is not None:
        econ = frame["economics"]
        stats += [
            ("cache hit rate", _fmt(econ["hit_rate"], "", 2)),
            ("coalesce rate", _fmt(econ["coalesce_rate"], "", 2)),
            ("extended sweeps", str(econ["extended"])),
        ]
    stat_tiles = "".join(
        f'<div class="tile"><div class="label">{esc(label)}</div>'
        f'<div class="value">{esc(value)}</div></div>'
        for label, value in stats)
    stamp = time.strftime("%Y-%m-%d %H:%M:%S",
                          time.localtime(frame["t"]))
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<title>nmfx-top — fleet dashboard</title>
<style>
  :root {{ color-scheme: light dark; }}
  body {{ font: 14px/1.5 system-ui, sans-serif; margin: 24px;
         color: #1f2430; background: #fcfcfd; }}
  @media (prefers-color-scheme: dark) {{
    body {{ color: #e4e6ee; background: #16181f; }}
    table td, table th {{ border-color: #33363f; }}
    .tile {{ border-color: #33363f; }} }}
  h1 {{ font-size: 18px; margin: 0 0 4px; }}
  .sub {{ opacity: .65; margin-bottom: 16px; }}
  table {{ border-collapse: collapse; margin: 8px 0 20px; }}
  th, td {{ border-bottom: 1px solid #e3e5ea; padding: 4px 12px;
            text-align: left; }}
  td.num {{ text-align: right; font-variant-numeric: tabular-nums; }}
  .tiles {{ display: flex; gap: 12px; flex-wrap: wrap;
            margin: 8px 0 20px; }}
  .tile {{ border: 1px solid #e3e5ea; border-radius: 6px;
           padding: 8px 14px; }}
  .tile .label {{ font-size: 12px; opacity: .65; }}
  .tile .value {{ font-size: 18px;
                  font-variant-numeric: tabular-nums; }}
  .chip {{ font-weight: 600; }}
</style></head><body>
<h1>nmfx fleet dashboard</h1>
<div class="sub">telemetry: {esc(telemetry_dir)} · rendered {stamp}
</div>
<h2>Instances</h2>
<div class="sub">roles: {esc(_role_summary(frame["instances"]))}</div>
<table><tr><th>instance</th><th>role</th><th>pid</th><th>device</th>
<th>hb age</th><th>state</th><th>queue</th><th>inflight</th></tr>
{inst_rows or '<tr><td colspan="8">no instances</td></tr>'}</table>
<h2>Serving</h2>
<div class="sub">outcomes: {outcome_row}</div>
<div class="tiles">{stat_tiles}</div>
<h2>SLO burn status</h2>
<table><tr><th>objective</th><th>state</th><th>burn per window</th>
</tr>{slo_rows}</table>
</body></html>
"""


def main(argv: "list[str] | None" = None) -> int:
    p = argparse.ArgumentParser(
        prog="nmfx-torch-top",
        description="Live terminal fleet dashboard over a shared "
                    "telemetry_dir: per-instance liveness/load, merged "
                    "latency quantiles and goodput, MFU, and SLO "
                    "burn-rate status.")
    p.add_argument("telemetry_dir",
                   help="the directory instances publish telemetry "
                        "snapshots into (ServeConfig.telemetry_dir)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh seconds (default 2)")
    p.add_argument("--stale-after", type=float, default=10.0,
                   help="heartbeat age beyond which an instance is "
                        "classified stale (default 10s)")
    p.add_argument("--once", action="store_true",
                   help="render a single frame and exit (rates that "
                        "need a window read n/a)")
    p.add_argument("--html", default=None, metavar="PATH",
                   help="write a static HTML render of one frame to "
                        "PATH and exit")
    args = p.parse_args(argv)
    if args.interval <= 0:
        p.error("--interval must be positive")
    collector = FleetCollector(args.telemetry_dir,
                               stale_after_s=args.stale_after)
    engine = _slo.SLOEngine(snapshot_fn=collector.fleet_snapshot)
    prev = None
    if args.html is not None or args.once:
        frame = gather(collector, engine, prev)
        if args.html is not None:
            with open(args.html, "w") as f:
                f.write(render_html(frame, args.telemetry_dir))
            print(f"nmfx-top: dashboard written to {args.html}",
                  file=sys.stderr)
        if args.once:
            print(render_text(frame, args.telemetry_dir), end="")
        return 0
    try:
        while True:
            frame = gather(collector, engine, prev)
            prev = (frame["t"], frame["snapshot"])
            sys.stdout.write("\x1b[2J\x1b[H"
                             + render_text(frame, args.telemetry_dir))
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
