"""``python -m active_learning_tpu_torch [experiment flags]`` runs an
active-learning experiment (experiment/cli.py), as ``python -m
active_learning_tpu`` does; ``python -m active_learning_tpu_torch serve
...`` serves an experiment's checkpoints (serve/cli.py).  The JAX
package's other verbs (``stream``, ``status``, ``report``, ``fleet``)
are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

import sys
from typing import List, Optional

VERBS = ("serve",)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in VERBS:
        from .serve.cli import main as serve_main
        return serve_main(argv[1:])
    if argv and not argv[0].startswith("-"):
        print(f"usage: python -m active_learning_tpu_torch "
              f"[{'|'.join(VERBS)}] [flags]  (got {argv[0]!r}: that verb "
              "is not ported yet, see ROADMAP.md)", file=sys.stderr)
        return 2
    from .experiment.cli import main as experiment_main
    return experiment_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
