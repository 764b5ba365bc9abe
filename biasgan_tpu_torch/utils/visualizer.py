"""Training observability (the reference's util/visualizer.py): the loss
lines of ``loss_log.txt`` in the reference's format, and the HTML snapshot
pages of the current visuals; and ``save_images``, the test driver's page
rows. Counterpart of ``biasgan_tpu/utils/visualizer.py``, less its
TensorBoard writer (it engages only where tensorboardX imports, and the
port's GPU host has no such package)."""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Dict

from biasgan_tpu_torch.utils import html as html_mod
from biasgan_tpu_torch.utils.imaging import save_image, tensor2im

_EPOCH_RE = re.compile(r"epoch(\d+)_")


def format_losses(epoch, iters, losses, t_comp, t_data) -> str:
    """The reference's loss line: ``(epoch: E, iters: I, time: T, data: D)
    name: v ...``."""
    msg = f"(epoch: {epoch}, iters: {iters}, time: {t_comp:.3f}, data: {t_data:.3f}) "
    return msg + " ".join(f"{k}: {v:.3f}" for k, v in losses.items())


class Visualizer:
    """The run's ``<run_dir>/loss_log.txt`` (a header line per run) and
    ``<run_dir>/web/`` pages. ``say`` prints a loss line (a rank's
    forwarder on ranks)."""

    def __init__(self, cfg, say: Callable[[str], None] = print):
        self.cfg = cfg
        self.say = say
        self.run_dir = cfg.run_dir()
        os.makedirs(self.run_dir, exist_ok=True)
        self.log_name = os.path.join(self.run_dir, "loss_log.txt")
        with open(self.log_name, "a") as f:
            f.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")
        self.web_dir = os.path.join(self.run_dir, "web")
        os.makedirs(os.path.join(self.web_dir, "images"), exist_ok=True)
        self._page_rows = None  # epoch -> its row's html, seeded from disk once

    def print_current_losses(self, epoch: int, iters: int, losses: Dict[str, float],
                             t_comp: float, t_data: float) -> None:
        """Print the loss line and append it to loss_log.txt. T is the
        step's seconds per sample at a print point, D the batch's wait."""
        msg = format_losses(epoch, iters, losses, t_comp, t_data)
        self.say(msg)
        with open(self.log_name, "a") as f:
            f.write(msg + "\n")

    def display_current_results(self, visuals: Dict, epoch: int) -> None:
        """Write ``web/images/epoch%03d_<label>.png`` of each visual (its
        first sample) and rebuild ``web/index.html``, newest epoch first.
        The rows are cached; the first call seeds the cache from the images
        already on disk, so a resumed run keeps its history."""
        for label, image in visuals.items():
            save_image(tensor2im(image),
                       os.path.join(self.web_dir, "images", f"epoch{epoch:03d}_{label}.png"))
        if self._page_rows is None:
            self._page_rows = self._scan_existing_rows(list(visuals))
        self._page_rows[epoch] = self._render_row(epoch, list(visuals))
        page = html_mod.HTML(self.web_dir, f"Experiment = {self.cfg.name}")
        for e in sorted(self._page_rows, reverse=True):
            page.rows.append(self._page_rows[e])
        page.save()

    def _render_row(self, epoch: int, labels) -> str:
        page = html_mod.HTML(self.web_dir, "")
        page.add_header(f"epoch [{epoch}]")
        ims = [f"epoch{epoch:03d}_{lab}.png" for lab in labels]
        page.add_images(ims, labels, ims)
        return "\n".join(page.rows)

    def _scan_existing_rows(self, labels) -> Dict[int, str]:
        rows: Dict[int, str] = {}
        first = labels[0] if labels else None
        for fname in os.listdir(os.path.join(self.web_dir, "images")):
            if first and fname.startswith("epoch") and fname.endswith(f"_{first}.png"):
                m = _EPOCH_RE.match(fname)
                if m:
                    e = int(m.group(1))
                    rows[e] = self._render_row(e, labels)
        return rows


def save_images(webpage, visuals, image_path, aspect_ratio: float = 1.0, width: int = 256):
    """The test driver's row for one sample: each visual's first sample as
    ``images/<name>_<label>.png`` (``name`` the sample's file name without
    its extension) under a header of the name."""
    image_dir = webpage.get_image_dir()
    short_path = os.path.basename(image_path[0] if isinstance(image_path, list) else image_path)
    name = os.path.splitext(short_path)[0].replace("/", "_").replace(":", "_")
    webpage.add_header(name)
    ims, txts, links = [], [], []
    for label, im_data in visuals.items():
        image_name = f"{name}_{label}.png"
        save_image(tensor2im(im_data), os.path.join(image_dir, image_name),
                   aspect_ratio=aspect_ratio)
        ims.append(image_name)
        txts.append(label)
        links.append(image_name)
    webpage.add_images(ims, txts, links, width=width)
