"""``python -m active_learning_tpu_torch <verb> ...``.

Slice 1 of the port carries one verb, ``serve`` (serve/cli.py).  The
JAX package's other verbs (the experiment driver, ``stream``,
``status``, ``report``, ``fleet``) are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import sys
from typing import List, Optional

VERBS = ("serve",)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in VERBS:
        got = argv[0] if argv else "(none)"
        print(f"usage: python -m active_learning_tpu_torch {{{','.join(VERBS)}}}"
              f" ...  (got {got!r}; the port's other verbs are not ported "
              "yet, see ROADMAP.md)", file=sys.stderr)
        return 2
    from .serve.cli import main as serve_main
    return serve_main(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
