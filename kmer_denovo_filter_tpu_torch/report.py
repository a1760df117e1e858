# Copied from kmer_denovo_filter_tpu/report.py
"""Self-contained interactive HTML report for both pipelines.

Functional twin of the reference report generator
(reference report.py, 2726 LoC): same loaders, the same six-stage
stratification cascade, the same figure inventory (funnel, stage
cascade, DKA_DKT histogram, DKA-vs-DKT scatter, PKC distributions,
contamination fractions, discovery region views, variant-type and
chromosome breakdowns) and per-variant table — but rendered as inline
SVG generated in Python, so the report is fully self-contained with
zero JavaScript/plotly dependencies.  Hover titles on every mark give
basic interactivity.
"""

import html
import json
import logging
import os
import re

logger = logging.getLogger(__name__)

_VARIANT_TABLE_MAX_ROWS = 100

# Heavy-dataset guards (same thresholds as reference report.py:72–80):
# scatters cap their point count (DE_NOVO variants always kept), and the
# evidence heatmap switches to k-means cluster-summary mode above
# _HEATMAP_MAX_ROWS so the report stays small at 100k+ variants.
SCATTER_MAX_POINTS = 2000
HEATMAP_MAX_ROWS = 200
HEATMAP_N_CLUSTERS = 8

# Six progressively stricter filtering stages (identical thresholds to
# reference report.py:26–45): every figure tells the same cascade story.
DKA_THRESHOLD = 0            # Stage 1: DKA > 0
DKA_STRONG_THRESHOLD = 5     # Stage 2: DKA >= 5
DKA_DKT_THRESHOLD = 0.1      # Stage 3: DKA_DKT > 0.1
MAX_PKC_ALT_THRESHOLD = 1    # Stage 4: MAX_PKC_ALT < 1
NHF_THRESHOLD = 0.05         # Stage 5: DKA_NHF < 0.05

STAGE_LABELS = [
    "Putative denovo (input VCF)",
    "Putative kmer denovo (DKA > 0)",
    "Putative kmer denovo (DKA ≥ 5)",
    "Higher-quality denovo (DKA_DKT > 0.1)",
    "Higher-quality denovo (MAX_PKC_ALT < 1)",
    "HQ, not contamination (NHF < 0.05)",
]
STAGE_COLORS = [
    "#4C78A8", "#F58518", "#E45756", "#72B7B2", "#EECA3B", "#54A24B",
]


# ── Loaders ────────────────────────────────────────────────────────


def _load_metrics(metrics_path):
    if not metrics_path or not os.path.isfile(metrics_path):
        return None
    with open(metrics_path) as fh:
        return json.load(fh)


def _load_summary_variants(summary_path):
    """Per-variant rows from a VCF-mode summary's Per-Variant table."""
    if not summary_path or not os.path.isfile(summary_path):
        return []
    variants = []
    in_table = False
    with open(summary_path) as fh:
        for line in fh:
            line = line.rstrip()
            if line.strip().startswith("Variant") and "DKU" in line:
                in_table = True
                continue
            if in_table and line.strip().startswith("-------"):
                continue
            if in_table and (not line.strip()
                             or line.strip().startswith("=")):
                break
            if not in_table:
                continue
            parts = line.split()
            if len(parts) < 14:
                continue
            try:
                variants.append({
                    "variant": f"{parts[0]} {parts[1]}",
                    "chrom": parts[0].rsplit(":", 1)[0],
                    "label": parts[1],
                    "dku": int(parts[2]),
                    "dkt": int(parts[3]),
                    "dka": int(parts[4]),
                    "dku_dkt": float(parts[5]),
                    "dka_dkt": float(parts[6]),
                    "max_pkc": int(parts[7]),
                    "avg_pkc": float(parts[8]),
                    "min_pkc": int(parts[9]),
                    "max_pkc_alt": int(parts[10]),
                    "avg_pkc_alt": float(parts[11]),
                    "min_pkc_alt": int(parts[12]),
                    "call": parts[13],
                })
            except (ValueError, IndexError):
                continue
    return variants


def _load_summary_counts(summary_path):
    """Headline counts from the summary's Variant Counts section."""
    counts = {}
    if not summary_path or not os.path.isfile(summary_path):
        return counts
    patterns = {
        "total": r"Total candidates analyzed:\s+(\d+)",
        "likely_dnm": r"Likely de novo \(DKU > 0\):\s+(\d+)",
        "inherited": r"Inherited / unclear \(DKU=0\):\s+(\d+)",
    }
    text = open(summary_path).read()
    for key, pat in patterns.items():
        m = re.search(pat, text)
        if m:
            counts[key] = int(m.group(1))
    return counts


def _load_vcf_kraken2_annotations(vcf_path):
    """{variant_key: {field: value}} for Kraken2 fraction fields."""
    if not vcf_path or not os.path.isfile(vcf_path):
        return {}
    from kmer_denovo_filter_tpu_torch.htsio.vcf import VcfReader
    fields = ("DKU_NHF", "DKA_NHF", "DKU_BF", "DKA_BF", "DKU_VF",
              "DKA_VF", "DKU_UCF", "DKA_UCF", "DKU_UF", "DKA_UF",
              "DKU_HLF", "DKA_HLF")
    try:
        vcf = VcfReader(vcf_path)
    except OSError:
        return {}
    out = {}
    for rec in vcf:
        ann = {}
        if vcf.samples and rec.format:
            keys = rec.format.split(":")
            vals = rec.sample_values[0].split(":")
            kv = dict(zip(keys, vals))
            for f in fields:
                if f in kv and kv[f] not in (".", ""):
                    try:
                        ann[f] = float(kv[f])
                    except ValueError:
                        pass
        else:
            for item in rec.info.split(";"):
                name, _, val = item.partition("=")
                if name in fields and val:
                    try:
                        ann[name] = float(val)
                    except ValueError:
                        pass
        if ann:
            alt = rec.alts[0] if rec.alts else "."
            out[f"{rec.chrom}:{rec.pos} {rec.ref}>{alt}"] = ann
    return out


def _merge_kraken2_into_variants(variants, kraken2_data):
    for v in variants:
        key = f"{v['chrom']}:{v['variant'].split(':')[1].split(' ')[0]}"
        ann = kraken2_data.get(f"{v['variant']}")
        if ann is None:
            # summary label and VCF label share "chrom:pos ref>alt"
            ann = kraken2_data.get(v["variant"])
        if ann:
            v.update({k.lower(): val for k, val in ann.items()})
    return variants


def _stratify_variant(v, has_nhf_data=None):
    """Deepest stage (0–5) the variant survives to."""
    if v["dka"] <= DKA_THRESHOLD:
        return 0
    if v["dka"] < DKA_STRONG_THRESHOLD:
        return 1
    if v["dka_dkt"] <= DKA_DKT_THRESHOLD:
        return 2
    if v["max_pkc_alt"] >= MAX_PKC_ALT_THRESHOLD:
        return 3
    if has_nhf_data:
        nhf = v.get("dka_nhf")
        if nhf is None or nhf >= NHF_THRESHOLD:
            return 4
        return 5
    return 4


def _compute_stratification(variants, has_nhf_data=None):
    """Counts surviving each cascade stage + per-variant stage index."""
    if has_nhf_data is None:
        has_nhf_data = any("dka_nhf" in v for v in variants)
    n_stages = 6 if has_nhf_data else 5
    stage_of = [_stratify_variant(v, has_nhf_data) for v in variants]
    for v, s in zip(variants, stage_of):
        v["stage"] = s
    surviving = []
    for s in range(n_stages):
        surviving.append(sum(1 for x in stage_of if x >= s))
    return {
        "n_stages": n_stages,
        "surviving": surviving,
        "stage_of": stage_of,
        "labels": STAGE_LABELS[:n_stages],
        "colors": STAGE_COLORS[:n_stages],
        "has_nhf_data": has_nhf_data,
    }


def _load_discovery_regions(metrics_path):
    m = _load_metrics(metrics_path)
    return (m or {}).get("regions", [])


def _load_discovery_candidate_comparison(metrics_path):
    m = _load_metrics(metrics_path)
    return (m or {}).get("candidate_comparison")


def _load_discovery_dnm_evaluation(metrics_path):
    m = _load_metrics(metrics_path)
    return (m or {}).get("dnm_evaluation")


def _downsample_variants(variants, max_points):
    """At most *max_points* variants, never dropping a DE_NOVO call.

    Inherited variants are uniformly strided down to fill the quota
    (reference report.py:88–110 semantics).  Returns
    ``(sampled, was_downsampled)``.
    """
    if len(variants) <= max_points:
        return variants, False
    denovo = [v for v in variants if v["call"] == "DE_NOVO"]
    rest = [v for v in variants if v["call"] != "DE_NOVO"]
    if len(denovo) >= max_points:
        return denovo[:max_points], True
    quota = max_points - len(denovo)
    stride = max(1, len(rest) // quota)
    return denovo + rest[::stride][:quota], True


def _kmeans_cluster(z_matrix, n_clusters, max_iter=100):
    """Deterministic numpy k-means (k-means++ seeding, seed 42).

    Same contract as reference report.py:113–178: a list of integer
    labels per row, stable across regenerations so the report is
    byte-reproducible.
    """
    import numpy as np

    x = np.asarray(z_matrix, dtype=np.float64)
    n = x.shape[0]
    if n <= n_clusters:
        return list(range(n))
    rng = np.random.RandomState(42)
    centres = [int(rng.randint(n))]
    for _ in range(n_clusters - 1):
        d2 = np.min(
            np.stack([((x - x[c]) ** 2).sum(axis=1) for c in centres]),
            axis=0)
        d2 = np.maximum(d2, 0.0)
        total = d2.sum()
        if total == 0:
            centres.append(int(rng.randint(n)))
        else:
            centres.append(int(rng.choice(n, p=d2 / total)))
    c = x[centres].copy()
    labels = np.zeros(n, dtype=np.int32)
    for _ in range(max_iter):
        d2 = ((x[:, None, :] - c[None, :, :]) ** 2).sum(axis=2)
        new = np.argmin(d2, axis=1).astype(np.int32)
        if np.array_equal(new, labels):
            break
        labels = new
        for j in range(n_clusters):
            m = labels == j
            if m.any():
                c[j] = x[m].mean(axis=0)
    return labels.tolist()


# ── SVG chart primitives ───────────────────────────────────────────

# Inline zoom/pan handler: scroll-wheel zoom about the cursor, drag to
# pan, double-click to reset — the interaction affordances the
# reference report gets from Plotly (reference report.py:1685, 2718),
# re-implemented as ~30 lines of dependency-free viewBox manipulation
# so the report stays fully self-contained (no external fetches).
_ZOOM_JS = """
document.querySelectorAll('svg').forEach(function (svg) {
  var a0 = svg.getAttribute('viewBox');
  if (!a0) return;
  var vb = a0.split(/[ ,]+/).map(Number), cur = vb.slice();
  function apply() { svg.setAttribute('viewBox', cur.join(' ')); }
  function pt(e) {
    var r = svg.getBoundingClientRect();
    return [cur[0] + (e.clientX - r.left) / r.width * cur[2],
            cur[1] + (e.clientY - r.top) / r.height * cur[3]];
  }
  svg.style.cursor = 'grab';
  svg.addEventListener('wheel', function (e) {
    e.preventDefault();
    var p = pt(e), f = e.deltaY < 0 ? 0.8 : 1.25;
    var w = Math.min(cur[2] * f, vb[2] * 8);
    var h = Math.min(cur[3] * f, vb[3] * 8);
    cur = [p[0] - (p[0] - cur[0]) * w / cur[2],
           p[1] - (p[1] - cur[1]) * h / cur[3], w, h];
    apply();
  }, {passive: false});
  var drag = null;
  svg.addEventListener('pointerdown', function (e) {
    drag = [e.clientX, e.clientY, cur[0], cur[1]];
    svg.setPointerCapture(e.pointerId);
    svg.style.cursor = 'grabbing';
  });
  svg.addEventListener('pointermove', function (e) {
    if (!drag) return;
    var r = svg.getBoundingClientRect();
    cur[0] = drag[2] - (e.clientX - drag[0]) / r.width * cur[2];
    cur[1] = drag[3] - (e.clientY - drag[1]) / r.height * cur[3];
    apply();
  });
  ['pointerup', 'pointercancel'].forEach(function (n) {
    svg.addEventListener(n, function () {
      drag = null; svg.style.cursor = 'grab';
    });
  });
  svg.addEventListener('dblclick', function () {
    cur = vb.slice(); apply();
  });
});
""".strip()


def _svg(width, height, body):
    return (f'<svg viewBox="0 0 {width} {height}" width="{width}" '
            f'height="{height}" xmlns="http://www.w3.org/2000/svg" '
            f'font-family="Helvetica,Arial,sans-serif">{body}</svg>')


def _esc(s):
    return html.escape(str(s), quote=True)


def _hbar_chart(labels, values, colors, title, width=760, note=None):
    """Horizontal bar chart with value labels and hover titles."""
    n = len(values)
    if n == 0:
        return ""
    bar_h = 30
    gap = 12
    top = 34
    left = 310
    height = top + n * (bar_h + gap) + 24
    vmax = max(max(values), 1)
    parts = [f'<text x="8" y="20" font-size="15" font-weight="bold">'
             f'{_esc(title)}</text>']
    for i, (lab, val) in enumerate(zip(labels, values)):
        y = top + i * (bar_h + gap)
        w = (width - left - 80) * val / vmax
        color = colors[i % len(colors)]
        parts.append(
            f'<text x="{left - 8}" y="{y + bar_h * 0.68}" font-size="12" '
            f'text-anchor="end">{_esc(lab)}</text>')
        parts.append(
            f'<rect x="{left}" y="{y}" width="{max(w, 1):.1f}" '
            f'height="{bar_h}" fill="{color}" rx="3">'
            f'<title>{_esc(lab)}: {val}</title></rect>')
        parts.append(
            f'<text x="{left + max(w, 1) + 6:.1f}" '
            f'y="{y + bar_h * 0.68}" font-size="12">{val}</text>')
    if note:
        parts.append(
            f'<text x="8" y="{height - 6}" font-size="11" fill="#666">'
            f'{_esc(note)}</text>')
    return _svg(width, height, "".join(parts))


def _histogram(values, bins, title, color="#4C78A8", width=760,
               height=260, x_label=""):
    if not values:
        return ""
    lo = min(values)
    hi = max(values)
    if hi == lo:
        hi = lo + 1
    step = (hi - lo) / bins
    counts = [0] * bins
    for v in values:
        b = min(int((v - lo) / step), bins - 1)
        counts[b] += 1
    cmax = max(counts)
    left, bottom, top = 50, 36, 30
    plot_w = width - left - 20
    plot_h = height - bottom - top
    parts = [f'<text x="8" y="20" font-size="15" font-weight="bold">'
             f'{_esc(title)}</text>']
    bw = plot_w / bins
    for i, c in enumerate(counts):
        h = plot_h * c / cmax if cmax else 0
        x = left + i * bw
        y = top + plot_h - h
        b_lo = lo + i * step
        parts.append(
            f'<rect x="{x:.1f}" y="{y:.1f}" width="{bw - 1:.1f}" '
            f'height="{h:.1f}" fill="{color}">'
            f'<title>[{b_lo:.3g}, {b_lo + step:.3g}): {c}</title></rect>')
    # axes
    parts.append(f'<line x1="{left}" y1="{top + plot_h}" '
                 f'x2="{left + plot_w}" y2="{top + plot_h}" '
                 f'stroke="#333"/>')
    parts.append(f'<text x="{left}" y="{height - 8}" font-size="11">'
                 f'{lo:.3g}</text>')
    parts.append(f'<text x="{left + plot_w}" y="{height - 8}" '
                 f'font-size="11" text-anchor="end">{hi:.3g}</text>')
    parts.append(f'<text x="{(left + width) / 2}" y="{height - 8}" '
                 f'font-size="11" text-anchor="middle">'
                 f'{_esc(x_label)}</text>')
    parts.append(f'<text x="{left - 6}" y="{top + 10}" font-size="11" '
                 f'text-anchor="end">{cmax}</text>')
    return _svg(width, height, "".join(parts))


def _scatter(points, title, x_label, y_label, width=760, height=330,
             logx=False, logy=False):
    """points: list of (x, y, color, label)."""
    import math
    if not points:
        return ""

    def tx(v):
        return math.log10(v + 1) if logx else v

    def ty(v):
        return math.log10(v + 1) if logy else v

    xs = [tx(p[0]) for p in points]
    ys = [ty(p[1]) for p in points]
    x_lo, x_hi = min(xs), max(xs)
    y_lo, y_hi = min(ys), max(ys)
    if x_hi == x_lo:
        x_hi = x_lo + 1
    if y_hi == y_lo:
        y_hi = y_lo + 1
    left, bottom, top = 56, 40, 30
    plot_w = width - left - 20
    plot_h = height - bottom - top
    parts = [f'<text x="8" y="20" font-size="15" font-weight="bold">'
             f'{_esc(title)}</text>']
    parts.append(f'<line x1="{left}" y1="{top + plot_h}" '
                 f'x2="{left + plot_w}" y2="{top + plot_h}" '
                 f'stroke="#333"/>')
    parts.append(f'<line x1="{left}" y1="{top}" x2="{left}" '
                 f'y2="{top + plot_h}" stroke="#333"/>')
    for x, y, color, label in points:
        px = left + plot_w * (tx(x) - x_lo) / (x_hi - x_lo)
        py = top + plot_h * (1 - (ty(y) - y_lo) / (y_hi - y_lo))
        parts.append(
            f'<circle cx="{px:.1f}" cy="{py:.1f}" r="4" fill="{color}" '
            f'fill-opacity="0.75"><title>{_esc(label)}</title></circle>')
    parts.append(f'<text x="{left + plot_w / 2}" y="{height - 8}" '
                 f'font-size="12" text-anchor="middle">'
                 f'{_esc(x_label)}</text>')
    parts.append(f'<text x="14" y="{top + plot_h / 2}" font-size="12" '
                 f'transform="rotate(-90 14 {top + plot_h / 2})" '
                 f'text-anchor="middle">{_esc(y_label)}</text>')
    return _svg(width, height, "".join(parts))


def _sankey_svg(nodes, links, title, width=760, height=420):
    """Minimal static Sankey: *nodes* = [(label, color, column)],
    *links* = [(src, dst, value)].  Node heights are proportional to
    their total flow; links render as cubic-bezier bands."""
    if not links:
        return ""
    n_cols = max(c for _, _, c in nodes) + 1
    col_x = [60 + (width - 220) * c / max(n_cols - 1, 1)
             for c in range(n_cols)]
    node_w = 16
    top, bottom = 46, 16
    plot_h = height - top - bottom

    flow_in = [0.0] * len(nodes)
    flow_out = [0.0] * len(nodes)
    for s, d, v in links:
        flow_out[s] += v
        flow_in[d] += v
    size = [max(flow_in[i], flow_out[i], 1e-9) for i in range(len(nodes))]

    by_col = {}
    for i, (_lab, _color, c) in enumerate(nodes):
        by_col.setdefault(c, []).append(i)
    col_total = {c: sum(size[i] for i in ids) for c, ids in by_col.items()}
    scale = min((plot_h - 14 * (len(ids) - 1)) / col_total[c]
                for c, ids in by_col.items())

    node_y = [0.0] * len(nodes)
    node_h = [0.0] * len(nodes)
    for c, ids in by_col.items():
        total_h = sum(size[i] * scale for i in ids) + 14 * (len(ids) - 1)
        y = top + (plot_h - total_h) / 2
        for i in ids:
            node_y[i] = y
            node_h[i] = size[i] * scale
            y += node_h[i] + 14

    parts = [f'<text x="8" y="20" font-size="15" font-weight="bold">'
             f'{_esc(title)}</text>']
    # links first (under the nodes)
    out_cursor = list(node_y)
    in_cursor = list(node_y)
    for s, d, v in links:
        h = v * scale
        x0 = col_x[nodes[s][2]] + node_w
        x1 = col_x[nodes[d][2]]
        y0 = out_cursor[s]
        y1 = in_cursor[d]
        out_cursor[s] += h
        in_cursor[d] += h
        mx = (x0 + x1) / 2
        parts.append(
            f'<path d="M{x0:.1f},{y0:.1f} C{mx:.1f},{y0:.1f} '
            f'{mx:.1f},{y1:.1f} {x1:.1f},{y1:.1f} L{x1:.1f},'
            f'{y1 + h:.1f} C{mx:.1f},{y1 + h:.1f} {mx:.1f},'
            f'{y0 + h:.1f} {x0:.1f},{y0 + h:.1f} Z" '
            f'fill="{nodes[s][1]}" fill-opacity="0.35">'
            f'<title>{_esc(nodes[s][0])} → {_esc(nodes[d][0])}: '
            f'{v:g}</title></path>')
    for i, (lab, color, c) in enumerate(nodes):
        x = col_x[c]
        parts.append(
            f'<rect x="{x:.1f}" y="{node_y[i]:.1f}" width="{node_w}" '
            f'height="{max(node_h[i], 2):.1f}" fill="{color}" rx="2">'
            f'<title>{_esc(lab)}</title></rect>')
        anchor = "start" if c < n_cols - 1 else "start"
        tx = x + node_w + 6
        if c == n_cols - 1 and tx > width - 150:
            tx = x + node_w + 6
        parts.append(
            f'<text x="{tx:.1f}" '
            f'y="{node_y[i] + max(node_h[i], 2) / 2 + 4:.1f}" '
            f'font-size="11" text-anchor="{anchor}">{_esc(lab)}</text>')
    return _svg(width, height, "".join(parts))


def _line_chart(xs, ys, title, x_label, y_label, vline=None,
                width=760, height=300, color="#4C78A8"):
    """Polyline chart with an optional dashed vertical marker."""
    if not xs:
        return ""
    x_lo, x_hi = min(xs), max(xs)
    y_lo, y_hi = 0, max(max(ys), 1)
    if x_hi == x_lo:
        x_hi = x_lo + 1
    left, bottom, top = 56, 40, 30
    plot_w = width - left - 20
    plot_h = height - bottom - top

    def px(v):
        return left + plot_w * (v - x_lo) / (x_hi - x_lo)

    def py(v):
        return top + plot_h * (1 - (v - y_lo) / (y_hi - y_lo))

    pts = " ".join(f"{px(x):.1f},{py(y):.1f}" for x, y in zip(xs, ys))
    parts = [f'<text x="8" y="20" font-size="15" font-weight="bold">'
             f'{_esc(title)}</text>',
             f'<line x1="{left}" y1="{top + plot_h}" '
             f'x2="{left + plot_w}" y2="{top + plot_h}" stroke="#333"/>',
             f'<line x1="{left}" y1="{top}" x2="{left}" '
             f'y2="{top + plot_h}" stroke="#333"/>',
             f'<polyline points="{pts}" fill="none" stroke="{color}" '
             f'stroke-width="2"/>']
    for x, y in zip(xs, ys):
        parts.append(f'<circle cx="{px(x):.1f}" cy="{py(y):.1f}" r="2" '
                     f'fill="{color}"><title>{x:g}: {y:g}</title>'
                     f'</circle>')
    if vline is not None and x_lo <= vline <= x_hi:
        parts.append(
            f'<line x1="{px(vline):.1f}" y1="{top}" '
            f'x2="{px(vline):.1f}" y2="{top + plot_h}" stroke="#E45756" '
            f'stroke-width="1.5" stroke-dasharray="5,4"/>')
        parts.append(
            f'<text x="{px(vline) + 4:.1f}" y="{top + 12}" '
            f'font-size="11" fill="#E45756">{vline:g}</text>')
    parts.append(f'<text x="{left + plot_w / 2}" y="{height - 8}" '
                 f'font-size="12" text-anchor="middle">'
                 f'{_esc(x_label)}</text>')
    parts.append(f'<text x="14" y="{top + plot_h / 2}" font-size="12" '
                 f'transform="rotate(-90 14 {top + plot_h / 2})" '
                 f'text-anchor="middle">{_esc(y_label)}</text>')
    # y-axis extremes
    parts.append(f'<text x="{left - 6}" y="{top + 10}" font-size="11" '
                 f'text-anchor="end">{y_hi:g}</text>')
    parts.append(f'<text x="{left - 6}" y="{top + plot_h}" '
                 f'font-size="11" text-anchor="end">0</text>')
    return _svg(width, height, "".join(parts))


def _quartiles(vals):
    s = sorted(vals)
    n = len(s)

    def q(p):
        if n == 1:
            return s[0]
        idx = p * (n - 1)
        lo = int(idx)
        hi = min(lo + 1, n - 1)
        frac = idx - lo
        return s[lo] * (1 - frac) + s[hi] * frac

    return q(0.25), q(0.5), q(0.75)


def _box_chart(groups, title, y_label, width=760, height=380):
    """groups: list of (label, values, color) → box-and-whisker SVG
    with a dashed mean line per box."""
    groups = [g for g in groups if g[1]]
    if not groups:
        return ""
    all_vals = [v for _, vals, _ in groups for v in vals]
    y_lo, y_hi = min(all_vals), max(all_vals)
    if y_hi == y_lo:
        y_hi = y_lo + 1
    pad = 0.06 * (y_hi - y_lo)
    y_lo -= pad
    y_hi += pad
    left, bottom, top = 56, 60, 30
    plot_w = width - left - 20
    plot_h = height - bottom - top
    slot = plot_w / len(groups)
    box_w = min(52, slot * 0.5)

    def py(v):
        return top + plot_h * (1 - (v - y_lo) / (y_hi - y_lo))

    parts = [f'<text x="8" y="20" font-size="15" font-weight="bold">'
             f'{_esc(title)}</text>',
             f'<line x1="{left}" y1="{top + plot_h}" '
             f'x2="{left + plot_w}" y2="{top + plot_h}" stroke="#333"/>',
             f'<line x1="{left}" y1="{top}" x2="{left}" '
             f'y2="{top + plot_h}" stroke="#333"/>']
    for i, (label, vals, color) in enumerate(groups):
        cx = left + slot * (i + 0.5)
        q1, med, q3 = _quartiles(vals)
        iqr = q3 - q1
        lo_w = min((v for v in vals if v >= q1 - 1.5 * iqr),
                   default=min(vals))
        hi_w = max((v for v in vals if v <= q3 + 1.5 * iqr),
                   default=max(vals))
        mean = sum(vals) / len(vals)
        x0 = cx - box_w / 2
        parts.append(
            f'<line x1="{cx:.1f}" y1="{py(lo_w):.1f}" x2="{cx:.1f}" '
            f'y2="{py(q1):.1f}" stroke="{color}"/>')
        parts.append(
            f'<line x1="{cx:.1f}" y1="{py(q3):.1f}" x2="{cx:.1f}" '
            f'y2="{py(hi_w):.1f}" stroke="{color}"/>')
        for wv in (lo_w, hi_w):
            parts.append(
                f'<line x1="{cx - box_w / 4:.1f}" y1="{py(wv):.1f}" '
                f'x2="{cx + box_w / 4:.1f}" y2="{py(wv):.1f}" '
                f'stroke="{color}"/>')
        parts.append(
            f'<rect x="{x0:.1f}" y="{py(q3):.1f}" width="{box_w:.1f}" '
            f'height="{max(py(q1) - py(q3), 1):.1f}" fill="{color}" '
            f'fill-opacity="0.45" stroke="{color}">'
            f'<title>{_esc(label)}: q1={q1:.2f} median={med:.2f} '
            f'q3={q3:.2f} mean={mean:.2f} n={len(vals)}</title></rect>')
        parts.append(
            f'<line x1="{x0:.1f}" y1="{py(med):.1f}" '
            f'x2="{x0 + box_w:.1f}" y2="{py(med):.1f}" '
            f'stroke="{color}" stroke-width="2"/>')
        parts.append(
            f'<line x1="{x0:.1f}" y1="{py(mean):.1f}" '
            f'x2="{x0 + box_w:.1f}" y2="{py(mean):.1f}" '
            f'stroke="{color}" stroke-dasharray="3,3"/>')
        for j, word in enumerate(label.split(" ")):
            parts.append(
                f'<text x="{cx:.1f}" y="{top + plot_h + 16 + 13 * j}" '
                f'font-size="10" text-anchor="middle">'
                f'{_esc(word)}</text>')
    parts.append(f'<text x="14" y="{top + plot_h / 2}" font-size="12" '
                 f'transform="rotate(-90 14 {top + plot_h / 2})" '
                 f'text-anchor="middle">{_esc(y_label)}</text>')
    parts.append(f'<text x="{left - 6}" y="{top + 10}" font-size="11" '
                 f'text-anchor="end">{y_hi:.3g}</text>')
    parts.append(f'<text x="{left - 6}" y="{top + plot_h}" '
                 f'font-size="11" text-anchor="end">{y_lo:.3g}</text>')
    return _svg(width, height, "".join(parts))


def _heat_color(z):
    """Diverging blue→white→red ramp for z-scores clipped to ±2.5."""
    z = max(-2.5, min(2.5, z)) / 2.5
    if z < 0:
        t = 1 + z  # 0 at -2.5 → blue; 1 at 0 → white
        r, g, b = int(49 + t * 206), int(104 + t * 151), 255
    else:
        t = 1 - z
        r, g, b = 255, int(64 + t * 191), int(52 + t * 203)
    return f"rgb({r},{g},{b})"


def _heatmap_svg(rows, row_labels, col_labels, title, hover_rows=None,
                 width=760):
    cell_h = 18
    left = 230
    top = 58
    height = top + cell_h * len(rows) + 20
    cell_w = (width - left - 16) / len(col_labels)
    parts = [f'<text x="8" y="20" font-size="15" font-weight="bold">'
             f'{_esc(title)}</text>']
    for c, lab in enumerate(col_labels):
        parts.append(
            f'<text x="{left + cell_w * (c + 0.5):.1f}" y="{top - 8}" '
            f'font-size="10" text-anchor="middle">{_esc(lab)}</text>')
    for r, row in enumerate(rows):
        y = top + r * cell_h
        parts.append(
            f'<text x="{left - 8}" y="{y + cell_h * 0.72:.1f}" '
            f'font-size="10" text-anchor="end">'
            f'{_esc(row_labels[r])}</text>')
        for c, z in enumerate(row):
            hover = (hover_rows[r][c] if hover_rows
                     else f"{col_labels[c]}: z={z:.2f}")
            parts.append(
                f'<rect x="{left + cell_w * c:.1f}" y="{y}" '
                f'width="{cell_w - 1:.1f}" height="{cell_h - 1}" '
                f'fill="{_heat_color(z)}">'
                f'<title>{_esc(row_labels[r])} — {_esc(hover)}</title>'
                f'</rect>')
    return _svg(width, height, "".join(parts))


def _stacked_bar_chart(labels, series, title, y_label, width=760,
                       height=420, note=None):
    """series: list of (name, values, color); one stacked bar/label."""
    if not labels:
        return ""
    totals = [sum(vals[i] for _n, vals, _c in series)
              for i in range(len(labels))]
    vmax = max(max(totals), 1e-9)
    left, bottom, top = 56, 120, 52
    plot_w = width - left - 20
    plot_h = height - bottom - top
    slot = plot_w / len(labels)
    bar_w = min(46, slot * 0.7)
    parts = [f'<text x="8" y="20" font-size="15" font-weight="bold">'
             f'{_esc(title)}</text>']
    # legend
    lx = left
    for name, _vals, color in series:
        parts.append(f'<rect x="{lx}" y="28" width="10" height="10" '
                     f'fill="{color}"/>')
        parts.append(f'<text x="{lx + 14}" y="37" font-size="10">'
                     f'{_esc(name)}</text>')
        lx += 14 + 7.2 * len(name) + 18
    for i, lab in enumerate(labels):
        cx = left + slot * (i + 0.5)
        y = top + plot_h
        for name, vals, color in series:
            h = plot_h * vals[i] / vmax
            y -= h
            parts.append(
                f'<rect x="{cx - bar_w / 2:.1f}" y="{y:.1f}" '
                f'width="{bar_w:.1f}" height="{max(h, 0):.1f}" '
                f'fill="{color}"><title>{_esc(lab)} — {_esc(name)}: '
                f'{vals[i]:.4f}</title></rect>')
        parts.append(
            f'<text x="{cx:.1f}" y="{top + plot_h + 12}" font-size="9" '
            f'text-anchor="end" transform="rotate(-45 {cx:.1f} '
            f'{top + plot_h + 12})">{_esc(lab)}</text>')
    parts.append(f'<line x1="{left}" y1="{top + plot_h}" '
                 f'x2="{left + plot_w}" y2="{top + plot_h}" '
                 f'stroke="#333"/>')
    parts.append(f'<text x="14" y="{top + plot_h / 2}" font-size="12" '
                 f'transform="rotate(-90 14 {top + plot_h / 2})" '
                 f'text-anchor="middle">{_esc(y_label)}</text>')
    if note:
        parts.append(
            f'<text x="8" y="{height - 4}" font-size="11" fill="#666">'
            f'{_esc(note)}</text>')
    return _svg(width, height, "".join(parts))


# ── Figures (same inventory as the reference) ──────────────────────


def _make_stratification_funnel(strat):
    return _hbar_chart(strat["labels"], strat["surviving"],
                       strat["colors"],
                       "Variant filtering cascade (stage survivors)")


def _make_kmer_funnel_chart(metrics, mode="vcf"):
    if not metrics:
        return ""
    if mode == "vcf":
        labels = ["Total child k-mers", "Found in parents",
                  "Child-unique k-mers"]
        values = [metrics.get("total_child_kmers", 0),
                  metrics.get("parent_found_kmers", 0),
                  metrics.get("child_unique_kmers", 0)]
    else:
        labels = ["Child candidate k-mers", "Non-reference k-mers",
                  "Proband-unique k-mers"]
        values = [metrics.get("child_candidate_kmers", 0),
                  metrics.get("non_ref_kmers", 0),
                  metrics.get("proband_unique_kmers", 0)]
    return _hbar_chart(labels, values,
                       ["#4C78A8", "#F58518", "#54A24B"],
                       "K-mer filtering funnel")


def _make_dka_dkt_histogram(variants):
    vals = [v["dka_dkt"] for v in variants]
    return _histogram(vals, 24, "DKA_DKT distribution",
                      x_label="DKA_DKT (allele-supporting fraction)")


def _make_dka_vs_dkt_scatter(variants):
    used, trimmed = _downsample_variants(variants, SCATTER_MAX_POINTS)
    pts = [(v["dkt"], v["dka"],
            "#54A24B" if v["call"] == "DE_NOVO" else "#9aa5b1",
            f"{v['variant']} DKA={v['dka']} DKT={v['dkt']} ({v['call']})")
           for v in used]
    title = "DKA vs DKT per variant (green = DE_NOVO call)"
    if trimmed:
        title += f" — showing {len(used)} of {len(variants)}"
    return _scatter(pts, title, "DKT (total fragments)",
                    "DKA (allele-supporting fragments)")


def _make_pkc_vs_dka_dkt_scatter(variants):
    used, trimmed = _downsample_variants(variants, SCATTER_MAX_POINTS)
    pts = [(max(v["max_pkc_alt"], 0), v["dka_dkt"],
            "#54A24B" if v["call"] == "DE_NOVO" else "#9aa5b1",
            f"{v['variant']} MAX_PKC_ALT={v['max_pkc_alt']} "
            f"DKA_DKT={v['dka_dkt']}")
           for v in used]
    title = "Parental k-mer support vs allele evidence"
    if trimmed:
        title += f" — showing {len(used)} of {len(variants)}"
    return _scatter(pts, title, "MAX_PKC_ALT (log scale)", "DKA_DKT",
                    logx=True)


def _make_pkc_histogram(variants):
    vals = [v["avg_pkc"] for v in variants if v["avg_pkc"] > 0]
    return _histogram(vals, 24, "AVG_PKC distribution (found in parents)",
                      color="#72B7B2", x_label="AVG_PKC")


def _make_nhf_distribution_plot(variants):
    vals = [v["dka_nhf"] for v in variants if "dka_nhf" in v]
    if not vals:
        return ""
    return _histogram(vals, 20, "DKA non-human fraction (Kraken2)",
                      color="#E45756", x_label="DKA_NHF")


def _classify_variant_type(label):
    """SNV / insertion / deletion / MNV from a 'REF>ALT' label."""
    m = re.match(r"^([A-Za-z]+)>([A-Za-z]+)$", label)
    if not m:
        return "other"
    ref, alt = m.group(1), m.group(2)
    if len(ref) == 1 and len(alt) == 1:
        return "SNV"
    if len(ref) < len(alt):
        return "insertion"
    if len(ref) > len(alt):
        return "deletion"
    return "MNV"


def _make_variant_type_breakdown(variants):
    from collections import Counter
    counts = Counter(_classify_variant_type(v["label"]) for v in variants)
    order = ["SNV", "insertion", "deletion", "MNV", "other"]
    labels = [o for o in order if counts.get(o)]
    return _hbar_chart(labels, [counts[o] for o in labels],
                       STAGE_COLORS, "Variant type breakdown")


def _make_chromosomal_distribution(variants):
    from collections import Counter

    def _key(chrom):
        c = chrom.replace("chr", "")
        return (0, int(c)) if c.isdigit() else (1, c)

    counts = Counter(v["chrom"] for v in variants)
    chroms = sorted(counts, key=_key)
    return _hbar_chart(chroms, [counts[c] for c in chroms],
                       ["#4C78A8"], "Variants per chromosome")


def _make_discovery_region_scatter(regions):
    pts = [(r["size"], r["reads"],
            {"SV": "#E45756", "AMBIGUOUS": "#F58518"}.get(
                r["class"], "#4C78A8"),
            f"{r['chrom']}:{r['start'] + 1}-{r['end']} "
            f"reads={r['reads']} kmers={r['unique_kmers']} "
            f"class={r['class']}")
           for r in regions]
    return _scatter(pts, "Discovery regions: size vs read support "
                    "(red=SV, orange=AMBIGUOUS)", "Region size (bp)",
                    "Supporting reads")


def _make_discovery_size_histogram(regions):
    return _histogram([r["size"] for r in regions], 20,
                      "Region size distribution", color="#72B7B2",
                      x_label="size (bp)")


def _make_sv_evidence_chart(regions):
    labels = []
    values = []
    for key, lab in (("split_reads", "split reads"),
                     ("discordant_pairs", "discordant pairs"),
                     ("unmapped_mates", "unmapped mates")):
        labels.append(f"Regions with {lab}")
        values.append(sum(1 for r in regions if r.get(key, 0) > 0))
    labels.append("Classified SV")
    values.append(sum(1 for r in regions if r.get("class") == "SV"))
    return _hbar_chart(labels, values,
                       ["#E45756", "#F58518", "#EECA3B", "#54A24B"],
                       "SV evidence across regions")


def _make_stratification_sankey(strat):
    """Pass/drop flow through the 6-stage cascade (reference
    report.py:575–646): each stage splits into a pass flow to the next
    stage and a grey drop node naming the failed criterion."""
    counts = strat["surviving"]
    labels = strat["labels"]
    colors = strat["colors"]
    n = strat["n_stages"]
    drop_reasons = [
        "Filtered: DKA = 0",
        "Filtered: DKA < 5",
        "Filtered: DKA_DKT ≤ 0.1",
        "Filtered: MAX_PKC_ALT ≥ 1",
        "Filtered: NHF ≥ 0.05 (contamination)",
    ]
    nodes = []
    for s in range(n):
        short = labels[s].split(" (")[0]
        nodes.append((f"{short} ({counts[s]:,})", colors[s], s))
    drop_base = n
    links = []
    for s in range(n - 1):
        dropped = counts[s] - counts[s + 1]
        nodes.append((f"{drop_reasons[s]} ({dropped:,})",
                      "#bbbbbb", s + 1))
        links.append((s, s + 1, max(1, counts[s + 1])))
        links.append((s, drop_base + s, max(1, dropped)))
    return _sankey_svg(nodes, links,
                       "Variant flow through stratification stages",
                       height=max(320, 70 * n))


def _make_kmer_sankey(metrics, mode="vcf"):
    """K-mer filtering flow Sankey (reference report.py:754–812)."""
    if not metrics:
        return ""
    if mode == "vcf":
        total = metrics.get("total_child_kmers", 0)
        found = metrics.get("parent_found_kmers", 0)
        uniq = metrics.get("child_unique_kmers", 0)
        nodes = [(f"Total child k-mers ({total:,})", "#4C78A8", 0),
                 (f"Found in parents ({found:,})", "#E45756", 1),
                 (f"Child-unique ({uniq:,})", "#54A24B", 1)]
        links = [(0, 1, max(1, found)), (0, 2, max(1, uniq))]
    else:
        cand = metrics.get("child_candidate_kmers", 0)
        non_ref = metrics.get("non_ref_kmers", 0)
        uniq = metrics.get("proband_unique_kmers", 0)
        ref_k = max(cand - non_ref, 0)
        parent_k = max(non_ref - uniq, 0)
        nodes = [(f"Child candidates ({cand:,})", "#4C78A8", 0),
                 (f"Reference k-mers ({ref_k:,})", "#BAB0AC", 1),
                 (f"Non-reference ({non_ref:,})", "#F58518", 1),
                 (f"Parental k-mers ({parent_k:,})", "#E45756", 2),
                 (f"Proband-unique ({uniq:,})", "#54A24B", 2)]
        links = [(0, 1, max(1, ref_k)), (0, 2, max(1, non_ref)),
                 (2, 3, max(1, parent_k)), (2, 4, max(1, uniq))]
    return _sankey_svg(nodes, links, "K-mer filtering flow", height=330)


_HEATMAP_FIELDS = ["dku", "dkt", "dka", "dku_dkt", "dka_dkt",
                   "max_pkc", "avg_pkc", "min_pkc"]
_HEATMAP_FIELD_LABELS = ["DKU", "DKT", "DKA", "DKU_DKT", "DKA_DKT",
                         "MAX_PKC", "AVG_PKC", "MIN_PKC"]


def _make_evidence_heatmap(variants):
    """Z-scored 8-feature evidence heatmap; k-means cluster-summary
    mode above HEATMAP_MAX_ROWS (reference report.py:928–1083)."""
    if not variants:
        return ""
    import statistics as stats
    n = len(variants)
    n_cols = len(_HEATMAP_FIELDS)
    raw = [[float(v[f]) for f in _HEATMAP_FIELDS] for v in variants]
    z = [[0.0] * n_cols for _ in range(n)]
    for c in range(n_cols):
        col = [raw[r][c] for r in range(n)]
        mean = stats.mean(col) if col else 0.0
        std = stats.pstdev(col) if col else 1.0
        if std == 0.0:
            std = 1.0
        for r in range(n):
            z[r][c] = (raw[r][c] - mean) / std

    if n > HEATMAP_MAX_ROWS:
        k = min(HEATMAP_N_CLUSTERS, n)
        cluster_ids = _kmeans_cluster(z, k)
        groups = {}
        for i, cl in enumerate(cluster_ids):
            groups.setdefault(cl, []).append(i)
        ranked = sorted(
            groups.values(),
            key=lambda idx: sum(
                1 for i in idx
                if variants[i]["call"] == "DE_NOVO") / len(idx),
            reverse=True)
        rows, row_labels, hovers = [], [], []
        for rank, idx in enumerate(ranked, start=1):
            centroid = [sum(z[i][c] for i in idx) / len(idx)
                        for c in range(n_cols)]
            centroid_raw = [sum(raw[i][c] for i in idx) / len(idx)
                            for c in range(n_cols)]
            dn = sum(1 for i in idx
                     if variants[i]["call"] == "DE_NOVO")
            rows.append(centroid)
            row_labels.append(
                f"Cluster {rank} — {len(idx):,} variants, "
                f"{100 * dn / len(idx):.0f}% de novo")
            hovers.append([
                f"{_HEATMAP_FIELD_LABELS[c]}: mean "
                f"{centroid_raw[c]:.2f} (z={centroid[c]:.2f})"
                for c in range(n_cols)])
        return _heatmap_svg(
            rows, row_labels, _HEATMAP_FIELD_LABELS,
            f"Evidence heatmap — cluster summary "
            f"({n:,} variants, k-means k={k})", hover_rows=hovers)

    rows = z
    row_labels = [v["variant"] for v in variants]
    hovers = [[f"{_HEATMAP_FIELD_LABELS[c]}: {raw[r][c]:g} "
               f"(z={z[r][c]:.2f})" for c in range(n_cols)]
              for r in range(n)]
    return _heatmap_svg(rows, row_labels, _HEATMAP_FIELD_LABELS,
                        "Evidence heatmap (z-scores per metric)",
                        hover_rows=hovers)


def _make_pkc_boxplot(variants):
    """MAX/AVG/MIN_PKC_ALT box plots by call type (reference
    report.py:1084–1128): ALT-allele counts, because only ALT-allele
    parental abundance separates de novo from inherited."""
    denovo = [v for v in variants if v["call"] == "DE_NOVO"]
    inherited = [v for v in variants if v["call"] != "DE_NOVO"]
    groups = []
    for glabel, group, color in (("De Novo", denovo, "#54A24B"),
                                 ("Inherited", inherited, "#E45756")):
        for metric, name in (("max_pkc_alt", "MAX_PKC_ALT"),
                             ("avg_pkc_alt", "AVG_PKC_ALT"),
                             ("min_pkc_alt", "MIN_PKC_ALT")):
            if group:
                groups.append((f"{name} ({glabel})",
                               [float(v[metric]) for v in group],
                               color))
    return _box_chart(groups,
                      "ALT-allele parental k-mer count by call type",
                      "PKC_ALT (count in parents)")


def _make_contamination_bar(variants):
    """Stacked Kraken2 fractions for putative-contamination variants
    (stage ≥ 1, NHF ≥ 0.05; reference report.py:1197–1272)."""
    labels, hlf, nhf, ucf, uf = [], [], [], [], []
    for v in variants:
        if v.get("stage", 0) < 1:
            continue
        val = v.get("dka_nhf")
        if val is None or val < NHF_THRESHOLD:
            continue
        labels.append(v["variant"])
        hlf.append(v.get("dka_hlf", 0.0))
        nhf.append(v.get("dka_nhf", 0.0))
        ucf.append(v.get("dka_ucf", 0.0))
        uf.append(v.get("dka_uf", 0.0))
    if not labels:
        return ""
    return _stacked_bar_chart(
        labels,
        [("Human lineage (HLF)", hlf, "#4C78A8"),
         ("Non-human (NHF)", nhf, "#E45756"),
         ("UniVec core (UCF)", ucf, "#F58518"),
         ("Unclassified (UF)", uf, "#BAB0AC")],
        f"Kraken2 read classification — putative contamination "
        f"(NHF ≥ {NHF_THRESHOLD}, n={len(labels)})",
        "Fraction of DKA reads")


def _make_contamination_funnel(strat, variants):
    """% of variants with NHF ≥ 0.05 surviving each stage (reference
    report.py:1273–1342) — shows how other filters remove (or retain)
    putative contamination."""
    if not strat["has_nhf_data"]:
        return ""
    pcts = []
    labels = []
    for s in range(strat["n_stages"]):
        at_stage = [v for i, v in enumerate(variants)
                    if strat["stage_of"][i] >= s]
        contam = sum(1 for v in at_stage
                     if v.get("dka_nhf") is not None
                     and v["dka_nhf"] >= NHF_THRESHOLD)
        total = len(at_stage)
        pct = 100.0 * contam / total if total else 0.0
        pcts.append(round(pct, 1))
        labels.append(f"{strat['labels'][s].split(' (')[0]} "
                      f"({contam}/{total})")
    if all(p == 0 for p in pcts):
        return ""
    return _hbar_chart(labels, pcts, strat["colors"],
                       "Contamination prevalence by stage "
                       "(% with NHF ≥ 0.05)")


def _make_threshold_sensitivity(variants):
    """Variants passing as the DKA_DKT threshold sweeps 0→1
    (reference report.py:1487–1524) with the 0.1 cutoff marked."""
    if not variants:
        return ""
    vals = sorted(v["dka_dkt"] for v in variants)
    thresholds = [i * 0.01 for i in range(101)]
    passing = [sum(1 for v in vals if v >= t) for t in thresholds]
    return _line_chart(thresholds, passing,
                       "DKA_DKT threshold sensitivity",
                       "DKA_DKT threshold", "Variants passing",
                       vline=DKA_DKT_THRESHOLD)


def _variant_table_html(variants, stage_of):
    rows = []
    for v, s in sorted(zip(variants, stage_of), key=lambda t: -t[1]):
        if s < 3:
            continue
        rows.append(
            "<tr>"
            f"<td>{_esc(v['variant'])}</td><td>{v['dku']}</td>"
            f"<td>{v['dkt']}</td><td>{v['dka']}</td>"
            f"<td>{v['dka_dkt']:.4f}</td><td>{v['max_pkc_alt']}</td>"
            f"<td>{_esc(v.get('dka_nhf', ''))}</td>"
            f"<td><span style='color:{STAGE_COLORS[s]}'>"
            f"stage {s}</span></td>"
            f"<td>{_esc(v['call'])}</td></tr>")
        if len(rows) >= _VARIANT_TABLE_MAX_ROWS:
            break
    if not rows:
        return "<p>No variants reached stage 3 (DKA_DKT &gt; 0.1).</p>"
    return (
        "<table><thead><tr><th>Variant</th><th>DKU</th><th>DKT</th>"
        "<th>DKA</th><th>DKA_DKT</th><th>MAX_PKC_ALT</th>"
        "<th>DKA_NHF</th><th>Stage</th><th>Call</th></tr></thead>"
        "<tbody>" + "".join(rows) + "</tbody></table>")


_CSS = """
body { font-family: Helvetica, Arial, sans-serif; margin: 0;
       color: #1c2733; background: #f6f8fa; }
header { background: #15304b; color: #fff; padding: 28px 40px; }
header h1 { margin: 0 0 6px 0; font-size: 26px; }
header p { margin: 0; opacity: 0.85; }
main { max-width: 960px; margin: 0 auto; padding: 24px 24px 60px; }
section { background: #fff; border-radius: 10px; padding: 20px 24px;
          margin: 18px 0; box-shadow: 0 1px 3px rgba(20,30,40,.08); }
section h2 { margin-top: 0; font-size: 19px; }
table { border-collapse: collapse; width: 100%; font-size: 13px; }
th, td { border-bottom: 1px solid #e3e8ee; padding: 6px 8px;
         text-align: left; }
th { background: #eef2f6; }
.stat-row { display: flex; gap: 16px; flex-wrap: wrap; }
.stat { flex: 1; min-width: 140px; background: #eef4fb;
        border-radius: 8px; padding: 12px 16px; }
.stat .v { font-size: 26px; font-weight: 700; }
.stat .l { font-size: 12px; color: #4c6172; }
.note { font-size: 12px; color: #667; }
"""


def generate_report(output_path, vcf_metrics_path=None,
                    vcf_summary_path=None, vcf_path=None,
                    discovery_metrics_path=None,
                    discovery_summary_path=None):
    """Write the self-contained HTML report; returns *output_path*."""
    vcf_metrics = _load_metrics(vcf_metrics_path)
    variants = _load_summary_variants(vcf_summary_path)
    counts = _load_summary_counts(vcf_summary_path)
    kraken2_data = _load_vcf_kraken2_annotations(vcf_path)
    if kraken2_data:
        _merge_kraken2_into_variants(variants, kraken2_data)
    disc_metrics = _load_metrics(discovery_metrics_path)
    regions = _load_discovery_regions(discovery_metrics_path)
    dnm_eval = _load_discovery_dnm_evaluation(discovery_metrics_path)
    cand_cmp = _load_discovery_candidate_comparison(discovery_metrics_path)

    sections = []

    if variants or vcf_metrics:
        strat = _compute_stratification(variants)
        stat_tiles = ""
        if counts:
            stat_tiles = (
                '<div class="stat-row">'
                f'<div class="stat"><div class="v">'
                f'{counts.get("total", len(variants))}</div>'
                '<div class="l">candidate variants</div></div>'
                f'<div class="stat"><div class="v">'
                f'{counts.get("likely_dnm", "–")}</div>'
                '<div class="l">likely de novo (DKU &gt; 0)</div></div>'
                f'<div class="stat"><div class="v">'
                f'{counts.get("inherited", "–")}</div>'
                '<div class="l">inherited / unclear</div></div>'
                '</div>')
        sections.append(
            "<section><h2>VCF mode — candidate annotation</h2>"
            + stat_tiles
            + _make_kmer_funnel_chart(vcf_metrics, "vcf")
            + _make_kmer_sankey(vcf_metrics, "vcf")
            + _make_stratification_funnel(strat)
            + _make_stratification_sankey(strat)
            + "</section>")
        sections.append(
            "<section><h2>Evidence distributions</h2>"
            + _make_dka_dkt_histogram(variants)
            + _make_dka_vs_dkt_scatter(variants)
            + _make_pkc_histogram(variants)
            + _make_pkc_boxplot(variants)
            + _make_pkc_vs_dka_dkt_scatter(variants)
            + _make_threshold_sensitivity(variants)
            + _make_evidence_heatmap(variants)
            + _make_nhf_distribution_plot(variants)
            + _make_contamination_bar(variants)
            + _make_contamination_funnel(strat, variants)
            + "</section>")
        sections.append(
            "<section><h2>Cohort breakdowns</h2>"
            + _make_variant_type_breakdown(variants)
            + _make_chromosomal_distribution(variants)
            + "</section>")
        sections.append(
            "<section><h2>Higher-quality de novo candidates "
            "(stage ≥ 3)</h2>"
            + _variant_table_html(variants, strat["stage_of"])
            + "</section>")

    if disc_metrics:
        tiles = (
            '<div class="stat-row">'
            f'<div class="stat"><div class="v">'
            f'{disc_metrics.get("candidate_regions", 0)}</div>'
            '<div class="l">candidate regions</div></div>'
            f'<div class="stat"><div class="v">'
            f'{disc_metrics.get("proband_unique_kmers", 0)}</div>'
            '<div class="l">proband-unique k-mers</div></div>'
            f'<div class="stat"><div class="v">'
            f'{disc_metrics.get("informative_reads", 0)}</div>'
            '<div class="l">informative reads</div></div>'
            '</div>')
        body = (
            "<section><h2>Discovery mode — VCF-free region scan</h2>"
            + tiles
            + _make_kmer_funnel_chart(disc_metrics, "discovery")
            + _make_kmer_sankey(disc_metrics, "discovery")
            + _make_discovery_region_scatter(regions)
            + _make_discovery_size_histogram(regions)
            + _make_sv_evidence_chart(regions))
        if cand_cmp:
            body += (
                f'<p class="note">High-quality candidate capture: '
                f'{cand_cmp.get("captured", 0)} / '
                f'{cand_cmp.get("hq_candidates", 0)} '
                f'({100 * cand_cmp.get("capture_rate", 0):.1f}%)</p>')
        if dnm_eval:
            body += (
                f'<p class="note">Curated DNM loci detected: '
                f'{dnm_eval.get("detected", 0)} / '
                f'{dnm_eval.get("total_loci", 0)}</p>')
        body += "</section>"
        sections.append(body)

    if not sections:
        sections.append(
            "<section><h2>No input data</h2><p>No metrics or summary "
            "files were provided.</p></section>")

    html_doc = (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        "<title>kmer-denovo report</title>"
        f"<style>{_CSS}</style></head><body>"
        "<header><h1>kmer-denovo — De Novo K-mer Filtering "
        "Report</h1>"
        "<p>K-mers present in the child but absent from both parents "
        "signal potential de novo mutations. This report summarises "
        "the filtering cascade and supporting evidence.</p>"
        "<p class='note'>Figures are interactive: scroll to zoom, "
        "drag to pan, double-click to reset.</p></header>"
        "<main>" + "".join(sections) + "</main>"
        f"<script>{_ZOOM_JS}</script></body></html>")
    with open(output_path, "w") as fh:
        fh.write(html_doc)
    logger.info("Report written: %s", output_path)
    return output_path
