"""Deprecated alias for the LM serving launcher (port of
``repro.launch.serve``).

Two serving entry points exist:

    python -m repro_torch.launch.serve_lm            # LM prefill/decode loop
    python -m repro_torch.launch.serve_registration  # registration solve server

``python -m repro_torch.launch.serve`` means the LM loop; it forwards there
(with a pointer printed) so the name stays unambiguous next to the
registration server.
"""

from __future__ import annotations

import sys

from .serve_lm import main  # noqa: F401  (re-export)

if __name__ == "__main__":
    print("[serve] note: `repro_torch.launch.serve` is the LM serving loop "
          "(alias of serve_lm); registration serving is "
          "`repro_torch.launch.serve_registration`.", file=sys.stderr)
    raise SystemExit(main())
