"""One self-contained HTML report of a training run: the counterpart of
catgen's ``tools/report.py``, which renders the same page from the same
files (the port's harness writes catgen's ``train_metrics.jsonl``, grids,
``collapse.json`` and ``quality_report.json``).

    python -m catgen_torch.tools.report runs/longrun   # -> report.html
    python -m catgen_torch.tools.report runs/longrun -o out.html
    python -m catgen_torch.tools.report runs/longrun --watch

Charts (inline SVG, no dependencies): D and G losses, D's accuracy and
gate, throughput, V's rating, D's sanity probes, the samples' saturation
and std and their distance to the corpus; the collapse verdict (the
stored ``collapse.json``, else ``scan_metrics`` of the metrics); the
quality report; a filmstrip of the sample grids. ``--watch`` re-renders
whenever the run writes new metrics or grids, and the page refreshes
itself in a browser (``<meta refresh>``).
"""

from __future__ import annotations

import argparse
import base64
import html
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from catgen_torch.eval.collapse import scan_metrics

# dataviz reference palette (validated categorical slots + status colors)
SERIES = ["#2a78d6", "#eb6834", "#1baf7a"]          # blue, orange, aqua
SERIES_DARK = ["#3987e5", "#d95926", "#199e70"]
GOOD, BAD = "#008300", "#e34948"

CSS = """
.viz-root { color-scheme: light;
  --surface-1:#fcfcfb; --surface-2:#f0efec; --text-primary:#0b0b0b;
  --text-secondary:#52514e; --grid:#e3e2df;
  --s1:#2a78d6; --s2:#eb6834; --s3:#1baf7a; --good:#008300; --bad:#e34948; }
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root { color-scheme: dark;
    --surface-1:#1a1a19; --surface-2:#383835; --text-primary:#ffffff;
    --text-secondary:#c3c2b7; --grid:#33332f;
    --s1:#3987e5; --s2:#d95926; --s3:#199e70; --bad:#e66767; } }
.viz-root { background:var(--surface-1); color:var(--text-primary);
  font:14px/1.45 system-ui,sans-serif; margin:0; padding:24px; }
.viz-root h1 { font-size:20px; margin:0 0 4px; }
.viz-root h2 { font-size:15px; margin:24px 0 8px; font-weight:600; }
.sub { color:var(--text-secondary); margin:0 0 16px; }
.charts { display:grid; grid-template-columns:repeat(auto-fill,minmax(340px,1fr));
  gap:20px; }
.chart { background:var(--surface-1); }
.chart svg { display:block; width:100%; height:auto; }
.chart .title { font-weight:600; margin-bottom:2px; }
.legend { display:flex; gap:14px; color:var(--text-secondary);
  font-size:12px; margin:2px 0 4px; flex-wrap:wrap; }
.legend .key { display:inline-flex; align-items:center; gap:5px; }
.legend .sw { width:14px; height:3px; border-radius:2px; display:inline-block; }
.banner { display:flex; align-items:center; gap:8px; padding:10px 14px;
  border-radius:6px; margin:14px 0; font-weight:600;
  background:var(--surface-2); }
.banner .dot { width:10px; height:10px; border-radius:50%; }
table.q { border-collapse:collapse; font-size:13px; }
table.q td, table.q th { padding:4px 12px 4px 0; text-align:left;
  border-bottom:1px solid var(--grid); font-weight:normal; }
table.q th { color:var(--text-secondary); }
.strip { display:flex; gap:8px; flex-wrap:wrap; }
.strip figure { margin:0; }
.strip img { image-rendering:pixelated; border:1px solid var(--grid);
  display:block; }
.strip figcaption { font-size:12px; color:var(--text-secondary);
  text-align:center; }
.tip { position:fixed; pointer-events:none; background:var(--surface-2);
  color:var(--text-primary); padding:6px 9px; border-radius:5px;
  font-size:12px; display:none; z-index:9; box-shadow:0 2px 8px #0003; }
"""

JS = """
(function(){
  const tip = document.createElement('div'); tip.className='tip';
  document.body.appendChild(tip);
  document.querySelectorAll('.chart svg[data-chart]').forEach(svg => {
    const d = JSON.parse(svg.dataset.chart);
    const cross = svg.querySelector('.cross');
    svg.addEventListener('mousemove', ev => {
      const pt = svg.createSVGPoint(); pt.x = ev.clientX; pt.y = ev.clientY;
      const p = pt.matrixTransform(svg.getScreenCTM().inverse());
      const fx = (p.x - d.x0) / (d.x1 - d.x0);
      if (fx < 0 || fx > 1) { tip.style.display='none';
        cross.setAttribute('opacity', 0); return; }
      let best = 0, bd = 1e9;
      d.x.forEach((xv, i) => { const dist = Math.abs(
        (xv - d.xmin) / (d.xmax - d.xmin || 1) - fx);
        if (dist < bd) { bd = dist; best = i; } });
      const cx = d.x0 + (d.x[best]-d.xmin)/(d.xmax-d.xmin||1)*(d.x1-d.x0);
      cross.setAttribute('x1', cx); cross.setAttribute('x2', cx);
      cross.setAttribute('opacity', 1);
      tip.innerHTML = '<b>epoch ' + d.x[best] + '</b><br>' +
        d.series.map((s, j) => s.name + ': ' +
          (s.y[best] == null ? '—' : s.y[best].toPrecision(4))).join('<br>');
      tip.style.display = 'block';
      tip.style.left = (ev.clientX + 14) + 'px';
      tip.style.top = (ev.clientY + 10) + 'px';
    });
    svg.addEventListener('mouseleave', () => { tip.style.display='none';
      cross.setAttribute('opacity', 0); });
  });
})();
"""


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _fmt_tick(v: float) -> str:
    if v == 0:
        return "0"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    return f"{v:.3g}"


def line_chart(title: str, xs: Sequence[float],
               series: List[Dict[str, Any]], y01: bool = False,
               subtitle: str = "") -> str:
    """Inline-SVG multi-line chart (2px lines, hairline grid, crosshair
    tooltip via the shared JS; legend for >=2 series)."""
    W, H = 360, 170
    x0, x1, y0, y1 = 42, W - 10, 12, H - 22
    xs = list(xs)
    if not xs:
        return ""
    vals = [v for s in series for v in s["y"] if v is not None]
    if not vals:
        return ""
    ymin = 0.0 if y01 else min(min(vals), 0.0)
    ymax = 1.0 if y01 else max(vals)
    if ymax <= ymin:
        ymax = ymin + 1.0
    pad = 0.04 * (ymax - ymin) if not y01 else 0.0
    ymin, ymax = ymin - pad, ymax + pad
    xmin, xmax = min(xs), max(xs)

    def X(v):
        return x0 + (v - xmin) / (xmax - xmin or 1) * (x1 - x0)

    def Y(v):
        return y1 - (v - ymin) / (ymax - ymin or 1) * (y1 - y0)

    parts = []
    # hairline grid at 4 y-ticks
    for i in range(5):
        yv = ymin + (ymax - ymin) * i / 4
        parts.append(f'<line x1="{x0}" y1="{Y(yv):.1f}" x2="{x1}" '
                     f'y2="{Y(yv):.1f}" stroke="var(--grid)" '
                     f'stroke-width="1"/>')
        parts.append(f'<text x="{x0 - 5}" y="{Y(yv) + 4:.1f}" '
                     f'text-anchor="end" font-size="10" '
                     f'fill="var(--text-secondary)">{_fmt_tick(yv)}</text>')
    for frac in (0, 0.5, 1.0):
        xv = xmin + (xmax - xmin) * frac
        parts.append(f'<text x="{X(xv):.1f}" y="{H - 8}" '
                     f'text-anchor="middle" font-size="10" '
                     f'fill="var(--text-secondary)">{int(xv)}</text>')
    for j, s in enumerate(series):
        pts = " ".join(f"{X(x):.1f},{Y(v):.1f}"
                       for x, v in zip(xs, s["y"]) if v is not None)
        color = f"var(--s{j + 1})"
        parts.append(f'<polyline points="{pts}" fill="none" '
                     f'stroke="{color}" stroke-width="2" '
                     f'stroke-linejoin="round" stroke-linecap="round"/>')
    parts.append(f'<line class="cross" x1="{x0}" y1="{y0}" x2="{x0}" '
                 f'y2="{y1}" stroke="var(--text-secondary)" '
                 f'stroke-width="1" opacity="0"/>')
    data = {"x": xs, "xmin": xmin, "xmax": xmax, "x0": x0, "x1": x1,
            "series": [{"name": s["name"], "y": s["y"]} for s in series]}
    legend = ""
    if len(series) >= 2:
        keys = "".join(
            f'<span class="key"><span class="sw" '
            f'style="background:var(--s{j + 1})"></span>'
            f'{html.escape(s["name"])}</span>'
            for j, s in enumerate(series))
        legend = f'<div class="legend">{keys}</div>'
    sub = (f'<div class="legend">{html.escape(subtitle)}</div>'
           if subtitle else "")
    return (f'<div class="chart"><div class="title">{html.escape(title)}'
            f'</div>{legend}{sub}'
            f'<svg viewBox="0 0 {W} {H}" data-chart=\''
            f'{html.escape(json.dumps(data), quote=True)}\'>'
            f'{"".join(parts)}</svg></div>')


def _col(events, field) -> List[Optional[float]]:
    return [e.get(field) for e in events]


def img_b64(path: str) -> str:
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def filmstrip(run_dir: str, sub: str = "images", n: int = 6) -> str:
    d = os.path.join(run_dir, sub)
    if not os.path.isdir(d):
        return ""
    files = sorted(f for f in os.listdir(d) if f.endswith(".png"))
    if not files:
        return ""
    if len(files) > n:
        idx = [round(i * (len(files) - 1) / (n - 1)) for i in range(n)]
        files = [files[i] for i in sorted(set(idx))]
    figs = []
    for f in files:
        ep = f.replace("epoch_", "").replace(".png", "").lstrip("0") or "0"
        figs.append(f'<figure><img width="160" alt="samples at epoch {ep}" '
                    f'src="data:image/png;base64,'
                    f'{img_b64(os.path.join(d, f))}"/>'
                    f'<figcaption>epoch {ep}</figcaption></figure>')
    return f'<div class="strip">{"".join(figs)}</div>'


def quality_table(q: Dict[str, Any]) -> str:
    rows = [
        ("D(generated) mean / p50", f"{q['d_scores_generated']['mean']:.3f}"
         f" / {q['d_scores_generated']['percentiles']['50']:.3f}"),
        ("D(real) mean / p50", f"{q['d_scores_real']['mean']:.3f} / "
         f"{q['d_scores_real']['percentiles']['50']:.3f}"),
        ("D fooled fraction", f"{q['d_fooled_fraction']:.3f}"),
        ("NN 2-norm mean (p5-p95)", f"{q['nn_l2']['mean']:.2f} "
         f"({q['nn_l2']['percentiles']['5']:.2f}-"
         f"{q['nn_l2']['percentiles']['95']:.2f})"),
        ("NN copy fraction", f"{q['nn_copy_fraction']:.3f}"),
        ("diversity pairwise L2 / pixel std",
         f"{q['diversity']['mean_pairwise_l2']:.2f} / "
         f"{q['diversity']['mean_per_pixel_std']:.3f}"),
    ]
    if "v_rating" in q:
        rows.append(("V rating all / best50",
                     f"{q['v_rating']['all']:.3f} / "
                     f"{q['v_rating']['best50_by_d']:.3f}"))
    body = "".join(f"<tr><th>{k}</th><td>{v}</td></tr>" for k, v in rows)
    return f'<table class="q">{body}</table>'


def build_report(run_dir: str, refresh: Optional[int] = None) -> str:
    events = read_jsonl(os.path.join(run_dir, "train_metrics.jsonl"))
    eps = [e for e in events if e.get("event") == "epoch"]
    viz = [e for e in events if e.get("event") == "viz"
           and "d_probe_pattern" in e]
    setup = next((e for e in events if e.get("event") == "setup"), {})
    if not viz:
        # curated artifact dirs (artifacts/longrun) carry the viz stream
        # as v_curve.json — the checkpoint's PLOT_DATA equivalent
        vc = os.path.join(run_dir, "v_curve.json")
        if os.path.exists(vc):
            viz = _read_json(vc)

    charts = []
    if eps:
        x = _col(eps, "epoch")
        charts.append(line_chart(
            "Adversarial losses (BCE)", x,
            [{"name": "loss_D", "y": _col(eps, "loss_d")},
             {"name": "loss_G", "y": _col(eps, "loss_g")}],
            subtitle="collapse pins loss_G at -log(eps) ~ 16"))
        charts.append(line_chart(
            "D accuracy & gate", x,
            [{"name": "acc_D", "y": _col(eps, "acc_d")},
             {"name": "D trained frac", "y": _col(eps, "d_trained_frac")}],
            y01=True))
        charts.append(line_chart(
            "Epoch throughput", x,
            [{"name": "images/sec", "y": _col(eps, "imgs_per_sec")}]))
    if viz:
        xv = _col(viz, "epoch")
        if any(v.get("v_rating_all") is not None for v in viz):
            charts.append(line_chart(
                "V rating (pseudo-validation, nn_utils.lua:177-182)", xv,
                [{"name": "all", "y": _col(viz, "v_rating_all")},
                 {"name": "D-best 50", "y": _col(viz, "v_rating_good")},
                 {"name": "D-worst 50", "y": _col(viz, "v_rating_bad")}],
                y01=True))
        charts.append(line_chart(
            "D sanity probes", xv,
            [{"name": "diagonal pattern (want low)",
              "y": _col(viz, "d_probe_pattern")},
             {"name": "real face (want high)",
              "y": _col(viz, "d_probe_real")}], y01=True))
        if any(v.get("sample_sat") is not None for v in viz):
            charts.append(line_chart(
                "Collapse signals on samples", xv,
                [{"name": "saturation frac (healthy <0.1)",
                  "y": _col(viz, "sample_sat")},
                 {"name": "per-pixel std (healthy ~0.15)",
                  "y": _col(viz, "sample_std")}]))
        if any(v.get("nn_l2_ratio") is not None for v in viz):
            charts.append(line_chart(
                "NN distance to corpus / corpus self-NN "
                "(healthy ~1.2, blob regime >1.45)", xv,
                [{"name": "nn_l2_ratio",
                  "y": _col(viz, "nn_l2_ratio")}]))

    # collapse verdict (stored verdict wins; else retro-scan)
    banner = ""
    cpath = os.path.join(run_dir, "collapse.json")
    mpath = os.path.join(run_dir, "train_metrics.jsonl")
    verdict = None
    if os.path.exists(cpath):
        verdict = _read_json(cpath)
    elif eps:
        verdict = scan_metrics(mpath)
    if verdict is not None:
        if verdict.get("collapsed"):
            banner = (f'<div class="banner"><span class="dot" '
                      f'style="background:var(--bad)"></span>'
                      f'&#9888; collapse detected: {verdict["reason"]} at '
                      f'epoch {verdict["fired_epoch"]}</div>')
        else:
            banner = ('<div class="banner"><span class="dot" '
                      'style="background:var(--good)"></span>'
                      '&#10003; no collapse signature detected</div>')

    qpath = os.path.join(run_dir, "quality_report.json")
    quality = ""
    if os.path.exists(qpath):
        quality = ("<h2>Quality report (BASELINE.md statistics)</h2>"
                   + quality_table(_read_json(qpath)))

    strips = ""
    main_strip = filmstrip(run_dir) or filmstrip(run_dir, "epochs")
    if main_strip:
        strips += "<h2>Sample grids (fixed noise)</h2>" + main_strip
    n_ep = eps[-1]["epoch"] if eps else 0
    head = (f"<h1>catgen run report</h1><p class=\"sub\">"
            f"{html.escape(os.path.abspath(run_dir))} &middot; "
            f"{n_ep} epochs &middot; G {setup.get('g_params', '?'):,} / "
            f"D {setup.get('d_params', '?'):,} params</p>"
            if setup.get("g_params") else
            f"<h1>catgen run report</h1><p class=\"sub\">"
            f"{html.escape(os.path.abspath(run_dir))} &middot; "
            f"{n_ep} epochs</p>")
    meta_refresh = (f"<meta http-equiv='refresh' content='{int(refresh)}'>"
                    if refresh else "")
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"{meta_refresh}"
            f"<title>catgen report</title><style>{CSS}</style></head>"
            f"<body class='viz-root'>{head}{banner}"
            f"<div class='charts'>{''.join(charts)}</div>"
            f"{quality}{strips}"
            f"<script>{JS}</script></body></html>")


def _run_signature(run_dir: str) -> tuple:
    """Cheap change detector for --watch: (mtime, size) of the metrics
    stream plus the newest grid mtime per images dir."""
    sig = []
    mpath = os.path.join(run_dir, "train_metrics.jsonl")
    if os.path.exists(mpath):
        st = os.stat(mpath)
        sig.append((mpath, st.st_mtime, st.st_size))
    for sub in ("images", "images_good", "images_bad", "epochs"):
        d = os.path.join(run_dir, sub)
        if os.path.isdir(d):
            pngs = [os.path.join(d, f) for f in os.listdir(d)
                    if f.endswith(".png")]
            if pngs:
                sig.append((sub, len(pngs), max(os.path.getmtime(f)
                                                for f in pngs)))
    return tuple(sig)


def watch(run_dir: str, out: str, interval: int = 20,
          max_renders: Optional[int] = None) -> int:
    """Re-render the report whenever the run writes new metrics or grids
    (poll every `interval` s). The emitted HTML carries a <meta refresh>
    matching the interval so an open browser tab tracks the run live.
    max_renders bounds the loop for tests; returns the render count."""
    renders = 0
    last_sig = None
    while True:
        sig = _run_signature(run_dir)
        if sig != last_sig:
            html_text = build_report(run_dir, refresh=max(interval, 1))
            tmp = out + ".tmp"
            with open(tmp, "w") as f:
                f.write(html_text)
            os.replace(tmp, out)   # atomic: a refreshing browser never
            renders += 1           # sees a half-written file
            last_sig = sig
            print(f"[report] re-rendered {out} "
                  f"({len(html_text) // 1024} KB)", flush=True)
        if max_renders is not None and renders >= max_renders:
            return renders
        time.sleep(interval)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default <run_dir>/report.html)")
    p.add_argument("--watch", action="store_true",
                   help="keep running: re-render whenever the run writes "
                        "new metrics or grids (live-dashboard mode)")
    p.add_argument("--interval", type=int, default=20,
                   help="--watch poll/auto-refresh period in seconds")
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.run_dir, "report.html")
    if args.watch:
        try:
            watch(args.run_dir, out, interval=args.interval)
        except KeyboardInterrupt:
            pass
        return
    html_text = build_report(args.run_dir)
    with open(out, "w") as f:
        f.write(html_text)
    print(f"[report] wrote {out} ({len(html_text) // 1024} KB)")


if __name__ == "__main__":
    main()
