"""Obs dashboard: one obs directory -> ONE self-contained HTML file (a
host-only copy of ``repro/obs/dashboard.py``).

``python -m repro_torch.obs.dashboard <obs-dir>`` renders any ``ObsWriter``
artifact set (run.json, metrics.jsonl, node_metrics.jsonl, events.jsonl,
rollup.json) into a single browsable HTML file with zero external
dependencies — every chart is inline SVG, every byte of data is embedded,
so the file survives as a CI artifact and opens anywhere.

Sections:

  * a KPI row (rounds, final residual, host round_ms, journal events),
  * convergence curves (r/s residuals, objective, penalty mean, edge
    fractions) as small-multiple line charts — one axis each, never two
    scales on one plot,
  * per-node heatmaps (primal residual, staleness age) on one-hue
    sequential ramps — rows are nodes, columns are drained rounds,
  * the topology/health event timeline — one lane per event type so
    identity is carried by position, with health lanes in the reserved
    status colors (icon + label, never color alone),
  * the per-node health table + advisory recommendations when the run's
    rollup carries them (``ObsWriter(health=True)``).

Self-check: the file embeds a JSON manifest of every series/section id it
promises to render; ``--check`` re-reads the HTML and verifies each
promised id is present (CI runs render + check on every obs-lane drill).

Colors are the repo-wide validated reference palette (categorical slots
are used at most two per chart; the sequential ramps are single-hue;
status colors are reserved for health severity) — values are taken
verbatim from the validated reference set, not invented here.
"""
from __future__ import annotations

import argparse
import html
import json
import os
import sys

import numpy as np

from repro_torch.obs import export as export_lib
from repro_torch.obs import schema

# ---------------------------------------------------------------- palette ----
# Verbatim reference palette values (validated set; light mode).
INK = "#0b0b0b"
INK_2 = "#52514e"
MUTED = "#898781"
GRID = "#e1e0d9"
AXIS = "#c3c2b7"
SURFACE = "#fcfcfb"
PAGE = "#f9f9f7"
SERIES_1 = "#2a78d6"   # categorical slot 1 (blue)
SERIES_2 = "#eb6834"   # categorical slot 2 (orange)
STATUS = {"good": "#0ca30c", "warning": "#fab219",
          "serious": "#ec835a", "critical": "#d03b3b"}
# one-hue sequential ramps, light -> dark (blue is the reference ramp;
# orange is the second sequential context per the palette's rule)
BLUE_RAMP = ["#cde2fb", "#b7d3f6", "#9ec5f4", "#86b6ef", "#6da7ec",
             "#5598e7", "#3987e5", "#2a78d6", "#256abf", "#1c5cab",
             "#184f95", "#104281", "#0d366b"]
ORANGE_RAMP = ["#fbe3d6", "#f8d2bc", "#f5c1a3", "#f3b08a", "#f09e71",
               "#ee8d58", "#eb7c40", "#e16a31", "#c95d2a", "#b05023",
               "#98441c", "#803815", "#672c0e"]

# health event name -> (status role, glyph) — icon + label, never color
# alone (status colors are reserved for state, which health IS)
HEALTH_LANES = {
    "health_divergence": ("critical", "▲"),
    "health_drift": ("critical", "▲"),
    "health_eta_stall": ("warning", "■"),
    "health_eta_oscillation": ("warning", "■"),
    "health_straggler": ("serious", "●"),
}


# ------------------------------------------------------------- load layer ----
def load_obs_dir(obs_dir: str) -> dict:
    """Read every artifact the writer may have left (missing -> empty)."""

    def jsonl(name):
        path = os.path.join(obs_dir, name)
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    def jsonf(name):
        path = os.path.join(obs_dir, name)
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    return {
        "dir": obs_dir,
        "meta": jsonf(export_lib.META_FILE),
        "rows": jsonl(export_lib.METRICS_FILE),
        "node_rows": jsonl(export_lib.NODE_METRICS_FILE),
        "events": jsonl(export_lib.EVENTS_FILE),
        "rollup": jsonf(export_lib.ROLLUP_FILE),
    }


# ------------------------------------------------------------ svg helpers ----
def _nice_ticks(lo: float, hi: float, n: int = 4) -> list[float]:
    if hi <= lo:
        hi = lo + 1.0
    raw = (hi - lo) / max(n, 1)
    mag = 10.0 ** np.floor(np.log10(raw))
    for m in (1, 2, 2.5, 5, 10):
        if raw <= m * mag:
            step = m * mag
            break
    t0 = np.ceil(lo / step) * step
    ticks = []
    t = t0
    while t <= hi + 1e-9 * step:
        ticks.append(float(t))
        t += step
    return ticks


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1e4 or a < 1e-3:
        return f"{v:.1e}"
    if a >= 100:
        return f"{v:,.0f}"
    if a >= 1:
        return f"{v:.3g}"
    return f"{v:.3g}"


def _esc(s) -> str:
    return html.escape(str(s), quote=True)


def line_chart(chart_id: str, title: str,
               series: list[tuple[str, list[float], list[float], str]],
               *, width: int = 420, height: int = 190,
               y_label: str = "") -> str:
    """One small-multiple line chart: 2px lines, hairline grid, ONE axis,
    end markers with a surface ring, legend for >= 2 series + direct end
    labels. ``series`` is ``[(name, xs, ys, color), ...]``."""
    pad_l, pad_r, pad_t, pad_b = 46, 74, 30, 26
    pw, ph = width - pad_l - pad_r, height - pad_t - pad_b
    xs_all = [x for _, xs, _, _ in series for x in xs]
    ys_all = [y for _, _, ys, _ in series for y in ys]
    if not xs_all:
        return (f'<svg id="series-{chart_id}" class="chart" width="{width}"'
                f' height="{height}"><text x="{width / 2}" y="{height / 2}"'
                f' text-anchor="middle" fill="{MUTED}" font-size="12">'
                f'{_esc(title)}: no data</text></svg>')
    x0, x1 = min(xs_all), max(xs_all)
    y0, y1 = min(ys_all), max(ys_all)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:
        y0, y1 = y0 - 0.5, y1 + 0.5
    y0 = min(y0, 0.0) if y0 > 0 and y0 / max(abs(y1), 1e-12) < 0.3 else y0

    def sx(x):
        return pad_l + pw * (x - x0) / (x1 - x0)

    def sy(y):
        return pad_t + ph * (1 - (y - y0) / (y1 - y0))

    out = [f'<svg id="series-{chart_id}" class="chart line-chart" '
           f'width="{width}" height="{height}" '
           f'data-chart="{_esc(chart_id)}" role="img" '
           f'aria-label="{_esc(title)}">']
    out.append(f'<text x="{pad_l}" y="16" fill="{INK}" font-size="12" '
               f'font-weight="600">{_esc(title)}</text>')
    for t in _nice_ticks(y0, y1):
        y = sy(t)
        out.append(f'<line x1="{pad_l}" y1="{y:.1f}" '
                   f'x2="{width - pad_r}" y2="{y:.1f}" '
                   f'stroke="{GRID}" stroke-width="1"/>')
        out.append(f'<text x="{pad_l - 5}" y="{y + 3.5:.1f}" '
                   f'text-anchor="end" fill="{MUTED}" font-size="9.5">'
                   f'{_fmt(t)}</text>')
    for t in _nice_ticks(x0, x1, 5):
        out.append(f'<text x="{sx(t):.1f}" y="{height - 8}" '
                   f'text-anchor="middle" fill="{MUTED}" font-size="9.5">'
                   f'{_fmt(t)}</text>')
    out.append(f'<line x1="{pad_l}" y1="{pad_t + ph}" '
               f'x2="{width - pad_r}" y2="{pad_t + ph}" '
               f'stroke="{AXIS}" stroke-width="1"/>')
    for name, xs, ys, color in series:
        pts = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in zip(xs, ys))
        out.append(f'<polyline points="{pts}" fill="none" stroke="{color}" '
                   f'stroke-width="2" stroke-linejoin="round" '
                   f'stroke-linecap="round"/>')
        # end marker: r>=4 fill + 2px surface ring, then the direct label
        ex, ey = sx(xs[-1]), sy(ys[-1])
        out.append(f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="6" '
                   f'fill="{SURFACE}"/>')
        out.append(f'<circle cx="{ex:.1f}" cy="{ey:.1f}" r="4" '
                   f'fill="{color}"/>')
        out.append(f'<text x="{ex + 8:.1f}" y="{ey + 3.5:.1f}" '
                   f'fill="{INK_2}" font-size="10">'
                   f'{_esc(name)} {_fmt(ys[-1])}</text>')
    if len(series) >= 2:       # legend: the dependable identity channel
        lx = pad_l
        for name, _, _, color in series:
            out.append(f'<rect x="{lx}" y="{pad_t - 8}" width="10" '
                       f'height="10" rx="2" fill="{color}"/>')
            out.append(f'<text x="{lx + 14}" y="{pad_t + 1}" '
                       f'fill="{INK_2}" font-size="10">{_esc(name)}</text>')
            lx += 20 + 6 * len(name)
    payload = {"title": title, "series": [
        {"name": n, "xs": list(map(float, xs)), "ys": list(map(float, ys)),
         "color": c} for n, xs, ys, c in series],
        "pad": [pad_l, pad_r, pad_t, pad_b]}
    out.append(f'<metadata class="chart-data">'
               f'{_esc(json.dumps(payload))}</metadata>')
    out.append("</svg>")
    return "".join(out)


def _ramp(v: float, vmax: float, ramp: list[str]) -> str:
    if vmax <= 0:
        return ramp[0]
    t = min(max(v / vmax, 0.0), 1.0)
    return ramp[int(round(t * (len(ramp) - 1)))]


def heatmap(chart_id: str, title: str, grid: list[list[float]],
            steps: list[int], *, ramp: list[str], unit: str = "",
            width: int = 640, int_vals: bool = False) -> str:
    """Per-node heatmap: rows = nodes, columns = drained rounds, one-hue
    sequential ramp (more = darker), 1px surface gaps, native per-cell
    tooltips. ``grid[i][t]`` is node i at drained round t."""
    j = len(grid)
    t_n = len(grid[0]) if j else 0
    pad_l, pad_t, pad_b = 46, 30, 24
    cell_h = max(10, min(22, 180 // max(j, 1)))
    pw = width - pad_l - 10
    cell_w = max(2.0, pw / max(t_n, 1))
    height = pad_t + j * cell_h + pad_b
    vmax = max((v for row in grid for v in row), default=0.0)
    out = [f'<svg id="series-{chart_id}" class="chart" width="{width}" '
           f'height="{height}" role="img" aria-label="{_esc(title)}">']
    out.append(f'<text x="{pad_l}" y="16" fill="{INK}" font-size="12" '
               f'font-weight="600">{_esc(title)}</text>')
    out.append(f'<text x="{width - 10}" y="16" text-anchor="end" '
               f'fill="{MUTED}" font-size="10">max '
               f'{_fmt(vmax)}{_esc(unit)}</text>')
    for i in range(j):
        y = pad_t + i * cell_h
        out.append(f'<text x="{pad_l - 6}" y="{y + cell_h / 2 + 3.5:.1f}" '
                   f'text-anchor="end" fill="{MUTED}" font-size="9.5">'
                   f'n{i}</text>')
        for t in range(t_n):
            v = grid[i][t]
            vtxt = str(int(v)) if int_vals else _fmt(v)
            out.append(
                f'<rect x="{pad_l + t * cell_w:.1f}" y="{y}" '
                f'width="{max(cell_w - 1, 1):.1f}" '
                f'height="{cell_h - 1}" '
                f'fill="{_ramp(v, vmax, ramp)}">'
                f'<title>node {i}, step {steps[t]}: {vtxt}{_esc(unit)}'
                f'</title></rect>')
    if t_n:
        for k in (0, t_n - 1):
            out.append(f'<text x="{pad_l + (k + 0.5) * cell_w:.1f}" '
                       f'y="{height - 8}" text-anchor="middle" '
                       f'fill="{MUTED}" font-size="9.5">'
                       f'step {steps[k]}</text>')
    # scale legend for the ramp (sequential needs one)
    sw = 90
    for n, c in enumerate(ramp):
        out.append(f'<rect x="{width - 10 - sw + n * sw / len(ramp):.1f}" '
                   f'y="{height - 16}" width="{sw / len(ramp):.1f}" '
                   f'height="8" fill="{c}"/>')
    out.append(f'<text x="{width - 10 - sw - 4}" y="{height - 8}" '
               f'text-anchor="end" fill="{MUTED}" font-size="9">0 → '
               f'{_fmt(vmax)}</text>')
    out.append("</svg>")
    return "".join(out)


def event_timeline(chart_id: str, events: list[dict], x0: int, x1: int,
                   *, width: int = 920) -> str:
    """One lane per event type (identity by position, not color); health
    lanes wear the reserved status colors with a glyph + label."""
    lanes: dict[str, list[dict]] = {}
    for e in events:
        lanes.setdefault(e.get("event", "?"), []).append(e)
    names = sorted(lanes, key=lambda n: (n.startswith("health_"), n))
    pad_l, pad_t, lane_h, pad_b = 190, 28, 20, 22
    height = pad_t + max(len(names), 1) * lane_h + pad_b
    if x1 <= x0:
        x1 = x0 + 1
    pw = width - pad_l - 16

    def sx(x):
        return pad_l + pw * (x - x0) / (x1 - x0)

    out = [f'<svg id="series-{chart_id}" class="chart" width="{width}" '
           f'height="{height}" role="img" '
           f'aria-label="topology and health event timeline">']
    out.append(f'<text x="{pad_l}" y="16" fill="{INK}" font-size="12" '
               f'font-weight="600">Topology &amp; health events</text>')
    if not names:
        out.append(f'<text x="{pad_l}" y="{pad_t + 14}" fill="{MUTED}" '
                   f'font-size="11">no events in this run</text>')
    for k, name in enumerate(names):
        y = pad_t + k * lane_h + lane_h / 2
        role_glyph = HEALTH_LANES.get(name)
        color = STATUS[role_glyph[0]] if role_glyph else SERIES_1
        glyph = (role_glyph[1] + " ") if role_glyph else ""
        out.append(f'<text x="{pad_l - 8}" y="{y + 3.5:.1f}" '
                   f'text-anchor="end" fill="{INK_2}" font-size="10">'
                   f'{glyph}{_esc(name)} ({len(lanes[name])})</text>')
        out.append(f'<line x1="{pad_l}" y1="{y:.1f}" x2="{width - 16}" '
                   f'y2="{y:.1f}" stroke="{GRID}" stroke-width="1"/>')
        for e in lanes[name]:
            tip = json.dumps({k2: v for k2, v in e.items()
                              if k2 != "event"})
            out.append(f'<circle cx="{sx(e.get("step", x0)):.1f}" '
                       f'cy="{y:.1f}" r="4" fill="{color}">'
                       f'<title>{_esc(name)} {_esc(tip)}</title></circle>')
    for t in _nice_ticks(x0, x1, 6):
        out.append(f'<text x="{sx(t):.1f}" y="{height - 6}" '
                   f'text-anchor="middle" fill="{MUTED}" font-size="9.5">'
                   f'{_fmt(t)}</text>')
    out.append("</svg>")
    return "".join(out)


# ---------------------------------------------------------- page assembly ----
def _stat_tile(label: str, value: str, note: str = "") -> str:
    return (f'<div class="tile"><div class="tile-label">{_esc(label)}</div>'
            f'<div class="tile-value">{_esc(value)}</div>'
            + (f'<div class="tile-note">{_esc(note)}</div>' if note else "")
            + "</div>")


def _health_table(health: dict) -> str:
    rows = []
    for n in health.get("nodes", []):
        active = [k for k in ("divergence", "eta_stall", "eta_oscillation",
                              "straggler", "drift") if n.get(k)]
        score = n.get("score", 1.0)
        role = ("good" if score >= 0.8 else
                "warning" if score >= 0.5 else "critical")
        glyph = {"good": "✓", "warning": "■", "critical": "▲"}[role]
        chip = (f'<span class="chip" style="background:{STATUS[role]}1a;">'
                f'<span style="color:{STATUS[role]}">{glyph}</span> '
                f'{score:.2f}</span>')
        rows.append(
            f'<tr><td>node {n.get("node")}</td><td>{chip}</td>'
            f'<td>{_esc(", ".join(active) or "—")}</td>'
            f'<td>{_esc(json.dumps(n.get("fires", {})) if n.get("fires") else "—")}</td>'
            f'<td>{n.get("lag", 0)}</td></tr>')
    return ('<table id="series-health_table" class="health">'
            '<thead><tr><th>node</th><th>score</th><th>active states</th>'
            '<th>episodes</th><th>clock lag</th></tr></thead>'
            '<tbody>' + "".join(rows) + "</tbody></table>")


_CSS = f"""
body {{ margin: 0; background: {PAGE}; color: {INK};
       font: 13px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif; }}
.wrap {{ max-width: 1000px; margin: 0 auto; padding: 20px 24px 48px; }}
h1 {{ font-size: 18px; margin: 6px 0 2px; }}
h2 {{ font-size: 14px; margin: 26px 0 8px; color: {INK}; }}
.meta {{ color: {INK_2}; font-size: 12px; }}
.panel {{ background: {SURFACE}; border: 1px solid rgba(11,11,11,0.10);
          border-radius: 8px; padding: 12px; margin: 8px 0; }}
.row {{ display: flex; flex-wrap: wrap; gap: 12px; }}
.tile {{ background: {SURFACE}; border: 1px solid rgba(11,11,11,0.10);
         border-radius: 8px; padding: 10px 14px; min-width: 120px; }}
.tile-label {{ color: {INK_2}; font-size: 11px; }}
.tile-value {{ font-size: 26px; font-weight: 600; }}
.tile-note {{ color: {MUTED}; font-size: 10.5px; }}
table.health {{ border-collapse: collapse; font-size: 12px; width: 100%; }}
table.health th {{ text-align: left; color: {INK_2}; font-weight: 600;
                   border-bottom: 1px solid {AXIS}; padding: 4px 10px; }}
table.health td {{ border-bottom: 1px solid {GRID}; padding: 4px 10px;
                   font-variant-numeric: tabular-nums; }}
.chip {{ border-radius: 10px; padding: 1px 8px; }}
.recs {{ color: {INK_2}; font-size: 12px; }}
.recs li {{ margin: 2px 0; }}
#tooltip {{ position: fixed; display: none; pointer-events: none;
            background: {SURFACE}; border: 1px solid rgba(11,11,11,0.18);
            border-radius: 6px; padding: 6px 9px; font-size: 11px;
            box-shadow: 0 2px 8px rgba(11,11,11,0.12); z-index: 10; }}
#tooltip .t-name {{ color: {INK_2}; }}
"""

_JS = """
// crosshair + tooltip over every line chart (nearest-x, all series)
const tip = document.getElementById('tooltip');
for (const svg of document.querySelectorAll('svg.line-chart')) {
  const meta = svg.querySelector('metadata.chart-data');
  if (!meta) continue;
  const data = JSON.parse(meta.textContent);
  const [padL, padR, padT, padB] = data.pad;
  const W = svg.width.baseVal.value, H = svg.height.baseVal.value;
  const xsAll = data.series.flatMap(s => s.xs);
  const x0 = Math.min(...xsAll), x1 = Math.max(...xsAll, x0 + 1);
  const cross = document.createElementNS('http://www.w3.org/2000/svg', 'line');
  cross.setAttribute('stroke', '#c3c2b7');
  cross.setAttribute('stroke-width', '1');
  cross.style.display = 'none';
  svg.appendChild(cross);
  svg.addEventListener('mousemove', ev => {
    const r = svg.getBoundingClientRect();
    const px = ev.clientX - r.left;
    const fx = x0 + (px - padL) / (W - padL - padR) * (x1 - x0);
    let best = null, bestD = Infinity;
    for (const s of data.series)
      for (let i = 0; i < s.xs.length; i++) {
        const d = Math.abs(s.xs[i] - fx);
        if (d < bestD) { bestD = d; best = s.xs[i]; }
      }
    if (best === null) return;
    const sx = padL + (best - x0) / (x1 - x0) * (W - padL - padR);
    cross.setAttribute('x1', sx); cross.setAttribute('x2', sx);
    cross.setAttribute('y1', padT); cross.setAttribute('y2', H - padB);
    cross.style.display = '';
    let rows = `<div class="t-name">step ${best}</div>`;
    for (const s of data.series) {
      const i = s.xs.indexOf(best);
      if (i >= 0) rows += `<div><span style="color:${s.color}">●</span> ` +
        `${s.name}: ${Number(s.ys[i].toPrecision(4))}</div>`;
    }
    tip.innerHTML = rows;
    tip.style.display = 'block';
    tip.style.left = (ev.clientX + 14) + 'px';
    tip.style.top = (ev.clientY + 10) + 'px';
  });
  svg.addEventListener('mouseleave', () => {
    cross.style.display = 'none'; tip.style.display = 'none';
  });
}
"""


def render_dashboard(obs_dir: str, out_path: str | None = None) -> str:
    """Render one obs directory into a self-contained HTML dashboard."""
    d = load_obs_dir(obs_dir)
    rows, node_rows, events = d["rows"], d["node_rows"], d["events"]
    rollup, meta = d["rollup"], d["meta"]
    steps = [int(r["step"]) for r in rows]
    manifest: list[str] = []
    parts: list[str] = []

    def series(key):
        return [float(r[key]) for r in rows]

    # ---- KPI row -------------------------------------------------------
    timing = rollup.get("timing", {}) or {}
    round_ms = timing.get("round_ms")
    health = rollup.get("health")
    tiles = [
        _stat_tile("Consensus rounds", str(len(rows)),
                   f"{rollup.get('dropped_rows', 0)} dropped"),
        _stat_tile("Final r_max",
                   _fmt(series("r_max")[-1]) if rows else "—"),
        _stat_tile("Host round time",
                   f"{round_ms:.1f} ms" if round_ms else "—",
                   f"{timing.get('drains', 0)} drains"),
        _stat_tile("Journal events", str(len(events))),
    ]
    if health:
        scores = [n.get("score", 1.0) for n in health.get("nodes", [])]
        tiles.append(_stat_tile(
            "Healthy nodes",
            f"{sum(s >= 0.8 for s in scores)}/{len(scores)}",
            f"min score {min(scores):.2f}" if scores else ""))
    parts.append('<div class="row">' + "".join(tiles) + "</div>")

    # ---- convergence small multiples (one axis each) -------------------
    charts = []
    if rows:
        charts.append(line_chart(
            "residuals", "Residuals (eq. 5)",
            [("r_max", steps, series("r_max"), SERIES_1),
             ("s_max", steps, series("s_max"), SERIES_2)]))
        charts.append(line_chart(
            "f_mean", "Mean local objective",
            [("f_mean", steps, series("f_mean"), SERIES_1)]))
        charts.append(line_chart(
            "eta_mean", "Mean penalty (eq. 7-9)",
            [("eta_mean", steps, series("eta_mean"), SERIES_1)]))
        charts.append(line_chart(
            "edges", "Edge fractions",
            [("active", steps, series("active_edges"), SERIES_1),
             ("stale", steps, series("stale_edges"), SERIES_2)]))
        manifest += ["residuals", "f_mean", "eta_mean", "edges"]
    parts.append("<h2>Convergence</h2><div class='panel'><div class='row'>"
                 + "".join(charts) + "</div></div>")

    # ---- per-node heatmaps ---------------------------------------------
    if node_rows:
        nsteps = [int(r["step"]) for r in node_rows]
        j = len(node_rows[0]["r"])
        r_grid = [[float(nr["r"][i]) for nr in node_rows] for i in range(j)]
        a_grid = [[float(nr["age_max"][i]) for nr in node_rows]
                  for i in range(j)]
        parts.append(
            "<h2>Per-node telemetry</h2><div class='panel'>"
            + heatmap("node_r", "Per-node primal residual r_i",
                      r_grid, nsteps, ramp=BLUE_RAMP)
            + heatmap("node_age", "Per-node staleness age (rounds)",
                      a_grid, nsteps, ramp=ORANGE_RAMP, int_vals=True)
            + "</div>")
        manifest += ["node_r", "node_age"]

    # ---- event timeline -------------------------------------------------
    x0 = min(steps) if steps else 0
    x1 = max(steps) if steps else 1
    parts.append("<h2>Events</h2><div class='panel'>"
                 + event_timeline("events", events, x0, x1) + "</div>")
    manifest.append("events")

    # ---- health ---------------------------------------------------------
    if health:
        recs = health.get("recommendations", {})
        rec_html = ""
        if recs.get("notes"):
            rec_html = ("<ul class='recs'>" + "".join(
                f"<li>{_esc(n)}</li>" for n in recs["notes"]) + "</ul>")
        else:
            rec_html = "<div class='recs'>no advisories</div>"
        parts.append("<h2>Health</h2><div class='panel'>"
                     + _health_table(health)
                     + "<h2>Advisory recommendations</h2>" + rec_html
                     + "</div>")
        manifest.append("health_table")

    codec = meta.get("wire_codec", "?")
    title = f"obs dashboard — {os.path.basename(os.path.abspath(obs_dir))}"
    doc = f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>{_esc(title)}</title>
<style>{_CSS}</style></head>
<body><div class="wrap">
<h1>{_esc(title)}</h1>
<div class="meta">schema v{meta.get('schema_version', '?')} ·
 codec {_esc(codec)} · {_esc(meta.get('scheme', ''))}
 · J={_esc(meta.get('num_nodes', '?'))}</div>
{''.join(parts)}
<div id="tooltip"></div>
<script type="application/json" id="dash-manifest">
{json.dumps({"series": manifest, "schema_version": schema.SCHEMA_VERSION})}
</script>
<script>{_JS}</script>
</div></body></html>
"""
    out_path = out_path or os.path.join(obs_dir, export_lib.DASHBOARD_FILE)
    with open(out_path, "w") as f:
        f.write(doc)
    return out_path


# ----------------------------------------------------------- self-check ----
def check_dashboard(path: str) -> dict:
    """Verify the rendered HTML delivers everything its manifest promises.

    The manifest is the render's own declaration of which series it chose
    to draw (data-dependent: no node rows -> no heatmaps promised), so
    this check catches a renderer that silently dropped a section, not a
    run that had nothing to show.
    """
    report = {"path": path, "errors": [], "series": []}
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        report["errors"].append(str(e))
        report["ok"] = False
        return report
    marker = 'id="dash-manifest">'
    at = text.find(marker)
    if at < 0:
        report["errors"].append("no dash-manifest block")
    else:
        end = text.find("</script>", at)
        try:
            manifest = json.loads(text[at + len(marker):end])
        except json.JSONDecodeError as e:
            manifest = {"series": []}
            report["errors"].append(f"manifest unparsable: {e}")
        report["series"] = manifest.get("series", [])
        for sid in report["series"]:
            if f'id="series-{sid}"' not in text:
                report["errors"].append(f"promised series missing: {sid}")
        if manifest.get("schema_version") != schema.SCHEMA_VERSION:
            report["errors"].append(
                f"schema version {manifest.get('schema_version')} != "
                f"{schema.SCHEMA_VERSION}")
    if "<svg" not in text:
        report["errors"].append("no SVG charts rendered")
    report["ok"] = not report["errors"]
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render an --obs-dir artifact set into one "
                    "self-contained HTML dashboard")
    ap.add_argument("obs_dir", help="ObsWriter output directory")
    ap.add_argument("-o", "--out", default=None,
                    help="output HTML path (default: <obs-dir>/dashboard.html)")
    ap.add_argument("--check", action="store_true",
                    help="after rendering, self-check the HTML (every "
                         "manifest-promised series present); exit 1 on fail")
    args = ap.parse_args(argv)
    path = render_dashboard(args.obs_dir, args.out)
    print(f"dashboard: {path}")
    if args.check:
        report = check_dashboard(path)
        print(json.dumps(report, indent=1, sort_keys=True))
        return 0 if report["ok"] else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
