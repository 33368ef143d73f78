"""Server status pages: the operator-facing HTML the reference renders
from weed/server/master_ui/ + volume_server_ui/ + filer_ui/ templates
(master_server_handlers_ui.go:1-35 etc.).  Plain tables, no assets, no
JS — `curl -H 'Accept: text/html'` or a browser both read it.

A copy of seaweedfs_tpu/server/ui.py, less the master's and the volume
server's pages (`render_master`, `render_volume`), which come with those
servers' HTML routes.  The port's filer renders its browser listing with
`wants_html` and `render_filer_listing`.
"""
from __future__ import annotations

import html
import time
import urllib.parse

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title><style>
body {{ font-family: sans-serif; margin: 2em; color: #222; }}
h1 {{ font-size: 1.4em; }} h2 {{ font-size: 1.1em; margin-top: 1.5em; }}
table {{ border-collapse: collapse; margin: 0.5em 0; }}
th, td {{ border: 1px solid #bbb; padding: 0.25em 0.7em; text-align: left; }}
th {{ background: #eee; }}
.muted {{ color: #777; font-size: 0.9em; }}
</style></head><body>
<h1>{title}</h1>
<p class="muted">seaweedfs-tpu &middot; rendered {now}</p>
{body}
</body></html>"""


def _esc(v) -> str:
    return html.escape(str(v))


def _table(headers: list[str], rows: list[list]) -> str:
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in row) + "</tr>"
        for row in rows
    )
    return f"<table><tr>{head}</tr>{body}</table>"


def _page(title: str, body: str) -> str:
    return _PAGE.format(
        title=_esc(title), now=time.strftime("%Y-%m-%d %H:%M:%S"), body=body
    )


def wants_html(request) -> bool:
    return "text/html" in request.headers.get("Accept", "")


def render_filer_listing(
    path: str, entries: list, limit: int, has_more: bool
) -> str:
    rows = []
    for e in entries:
        name = e.name + ("/" if e.is_directory else "")
        # percent-encode the segment: names with %, ?, # or spaces must
        # not be parsed as URL syntax by the browser
        href = (
            urllib.parse.quote(path.rstrip("/"))
            + "/"
            + urllib.parse.quote(e.name)
        )
        rows.append([
            f'<a href="{_esc(href)}">{_esc(name)}</a>',
            "-" if e.is_directory else e.attr.file_size,
            time.strftime(
                "%Y-%m-%d %H:%M:%S", time.localtime(e.attr.mtime or 0)
            ),
            f"{e.attr.mode & 0o7777:o}",
        ])
    body = [f"<h2>{_esc(path.rstrip('/') or '/')}</h2>"]
    # the name cell is pre-escaped html (an anchor): render raw
    head = "".join(
        f"<th>{h}</th>" for h in ("name", "size", "modified", "mode")
    )
    trs = "".join(
        "<tr><td>" + r[0] + "</td>"
        + "".join(f"<td>{_esc(c)}</td>" for c in r[1:])
        + "</tr>"
        for r in rows
    )
    body.append(f"<table><tr>{head}</tr>{trs}</table>")
    if has_more:
        body.append(
            f'<p class="muted">showing first {limit}; pass ?limit= for more</p>'
        )
    return _page("seaweedfs-tpu filer", "".join(body))
