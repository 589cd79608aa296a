"""Static HTML results page (port of `radae_tpu/tools/report.py`, stdlib
only).

Renders measured records — evaluation sweep JSONs (tools/evaluate.py
--json) and bench records, each a file the caller names — into one
self-contained HTML page: the results-publishing role the reference fills
with its hand-edited README tables and public_html pages.  It reads no file
the caller did not name, so the page shows only the records given, each
beside its file's name.

    python -m radae_tpu_torch report out.html --sweep sweep.json \\
        --bench bench_line.json
"""

from __future__ import annotations

import argparse
import html
import json
import os
import sys

CSS = """
body { font-family: system-ui, sans-serif; margin: 2em auto; max-width: 60em;
       color: #1a1a2e; }
h1, h2 { font-weight: 600; }
table { border-collapse: collapse; margin: 1em 0; }
th, td { border: 1px solid #c8c8d4; padding: 0.35em 0.8em; text-align: right; }
th { background: #eef0f6; }
td:first-child, th:first-child { text-align: left; }
.meta { color: #667; font-size: 0.9em; }
"""


def sweep_table(path: str) -> str:
    table = json.load(open(path))
    # keys "channel@EbNo" -> grid
    cells = {}
    for k, v in table.items():
        ch, e = k.rsplit("@", 1)
        cells[(ch, float(e))] = v
    # first-seen order from the JSON (insertion-ordered), deduplicated —
    # a computed sort key would tie on a shared EbNo grid and fall back to
    # nondeterministic set ordering
    channels = list(dict.fromkeys(k.rsplit("@", 1)[0] for k in table))
    ebnos = sorted({e for _, e in cells})
    rows = [f"<h2>Evaluation sweep <span class=meta>({html.escape(path)})"
            f"</span></h2>", "<table><tr><th>channel</th>"]
    rows += [f"<th>{e:g} dB</th>" for e in ebnos] + ["</tr>"]
    for ch in channels:
        rows.append(f"<tr><td>{html.escape(ch)}</td>" + "".join(
            f"<td>{cells[(ch, e)]:.3f}</td>" if (ch, e) in cells
            else "<td>—</td>" for e in ebnos) + "</tr>")
    rows.append("</table>")
    return "\n".join(rows)


def bench_table(paths) -> str:
    """One row per bench record file in `paths`: a bench's JSON line
    ({"metric", "value", "unit", ...}) or a record holding it under
    "parsed"."""
    if not paths:
        return ""
    rows = ["<h2>Bench records</h2>",
            "<table><tr><th>record</th><th>metric</th><th>value</th>"
            "<th>unit</th><th>config</th></tr>"]
    for f in paths:
        rec = json.load(open(f))
        parsed = rec.get("parsed") or rec  # raw bench line or a record
        name = html.escape(os.path.basename(f))
        if not isinstance(parsed, dict) or "metric" not in parsed:
            rows.append(f"<tr><td>{name}</td><td colspan=4 class=meta>"
                        f"no parsed result</td></tr>")
            continue
        rows.append(
            f"<tr><td>{name}</td><td>{html.escape(str(parsed['metric']))}"
            f"</td><td>{parsed['value']:,.1f}</td>"
            f"<td>{html.escape(str(parsed.get('unit', '')))}</td>"
            f"<td>{html.escape(str(parsed.get('config', '')))}</td></tr>")
    rows.append("</table>")
    return "\n".join(rows)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_html")
    p.add_argument("--sweep", action="append", default=[],
                   help="sweep JSON from tools/evaluate.py (repeatable)")
    p.add_argument("--bench", action="append", default=[],
                   help="a bench record JSON file (repeatable)")
    p.add_argument("--title", default="radae_tpu_torch results")
    args = p.parse_args(argv)

    parts = [f"<!doctype html><html><head><meta charset=utf-8>"
             f"<title>{html.escape(args.title)}</title>"
             f"<style>{CSS}</style></head><body>"
             f"<h1>{html.escape(args.title)}</h1>"]
    for s in args.sweep:
        parts.append(sweep_table(s))
    parts.append(bench_table(args.bench))
    parts.append("</body></html>")
    with open(args.out_html, "w") as f:
        f.write("\n".join(parts))
    print(f"wrote {args.out_html}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
