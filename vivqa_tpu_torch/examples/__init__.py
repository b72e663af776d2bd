"""The walkthroughs of ``examples/`` on the port: each keeps the JAX
file's sections and what they print, told of the PyTorch package.

    python3 -m vivqa_tpu_torch.examples.<name> [--device cpu]

They run on the card unless given ``--device cpu`` (the plain path), and
raise without one. ``<name>`` is one of the ten files here. Their demo
models keep every attention head 32 wide (the port's attention kernels
take head dims 32, 64 and 128), where the JAX files' demos used 8-16.
"""

from __future__ import annotations

import argparse
import ast
from pathlib import Path
from typing import Optional, Sequence

from vivqa_tpu_torch.device import resolve_device


def banner(title: str) -> None:
    print(f"\n{'=' * 64}\n{title}\n{'=' * 64}")


def banner_titles(path: Path) -> list:
    """The titles a walkthrough at ``path`` prints with ``banner("...")``,
    read from its source by ``ast`` (the file is not run): the sections
    that its counterpart here must print too."""
    tree = ast.parse(Path(path).read_text())
    return [node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == "banner"
            and node.args and isinstance(node.args[0], ast.Constant)]


def parse_args(doc: str, argv: Optional[Sequence[str]] = None,
               parser: Optional[argparse.ArgumentParser] = None
               ) -> argparse.Namespace:
    """``--device`` (and ``parser``'s own flags); the device is checked
    here, so a run that asks for a card on a host without one stops before
    it builds anything."""
    ap = parser or argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    args.device = str(resolve_device(args.device))
    return args
