"""Plain-HTML result pages (the reference's util/html.py writes them with
dominate). Counterpart of ``biasgan_tpu/utils/html.py``: the same rows and
the same ``index.html`` text."""

from __future__ import annotations

import os
from typing import List


class HTML:
    """A page of headers and image rows under ``web_dir``; its images live
    in ``web_dir/images``. ``refresh`` > 0 reloads the page every that many
    seconds."""

    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.title = title
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        os.makedirs(self.img_dir, exist_ok=True)
        self.rows: List[str] = []
        self.refresh = refresh

    def get_image_dir(self) -> str:
        return self.img_dir

    def add_header(self, text: str) -> None:
        self.rows.append(f"<h3>{text}</h3>")

    def add_images(self, ims: List[str], txts: List[str], links: List[str], width=256) -> None:
        """One table row: each image (a file in images/) with its caption,
        linking to ``links``' file."""
        cells = [
            f'<td style="text-align:center"><a href="images/{link}">'
            f'<img src="images/{im}" width="{width}"></a><br>{txt}</td>'
            for im, txt, link in zip(ims, txts, links)
        ]
        self.rows.append(
            '<table style="border-collapse:collapse"><tr>' + "".join(cells) + "</tr></table>"
        )

    def save(self) -> str:
        """Write ``web_dir/index.html``; returns its path."""
        refresh = (
            f'<meta http-equiv="refresh" content="{self.refresh}">' if self.refresh else ""
        )
        body = "\n".join(self.rows)
        doc = (
            f"<!DOCTYPE html><html><head><title>{self.title}</title>{refresh}"
            f"</head><body>{body}</body></html>"
        )
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as f:
            f.write(doc)
        return path
