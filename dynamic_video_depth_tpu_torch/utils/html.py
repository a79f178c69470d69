"""Minimal HTML report builders (counterpart of
``dynamic_video_depth_tpu/utils/html.py``; reference
util/util_html.py:21-125). The pages are the JAX package's, byte for byte."""

from __future__ import annotations

import os
from typing import List


class Webpage:
    """Video/image gallery page (reference: util/util_html.py Webpage)."""

    def __init__(self, title: str = "results"):
        self.title = title
        self.items: List[str] = []

    def add_video(self, path: str, title: str = ""):
        self.items.append(
            f"<div><h3>{title}</h3>"
            f"<video controls autoplay loop muted src='{path}' "
            f"width='720'></video></div>"
        )

    def add_image(self, path: str, title: str = ""):
        self.items.append(
            f"<div><h3>{title}</h3><img src='{path}' width='720'/></div>"
        )

    def add_text(self, text: str):
        self.items.append(f"<p>{text}</p>")

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        body = "\n".join(self.items)
        with open(path, "w") as f:
            f.write(
                f"<html><head><title>{self.title}</title></head>"
                f"<body style='background:#111;color:#eee'>{body}</body></html>"
            )


class ImageTable:
    """Per-epoch image grid page (reference: loggers/html_template.py and
    visualize/html_visualizer.py table rows)."""

    def __init__(self, title: str = "visualization"):
        self.title = title
        self.rows: List[List[str]] = []
        self.header: List[str] = []

    def set_header(self, cols: List[str]):
        self.header = cols

    def add_row(self, cells: List[str]):
        self.rows.append(cells)

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        head = "".join(f"<th>{c}</th>" for c in self.header)
        rows = "\n".join(
            "<tr>" + "".join(
                f"<td><img src='{c}' width='256'/><br/>{os.path.basename(c)}</td>"
                if c.endswith(".png") else f"<td>{c}</td>"
                for c in row
            ) + "</tr>"
            for row in self.rows
        )
        with open(path, "w") as f:
            f.write(
                f"<html><head><title>{self.title}</title></head><body>"
                f"<table border=1><tr>{head}</tr>{rows}</table></body></html>"
            )
