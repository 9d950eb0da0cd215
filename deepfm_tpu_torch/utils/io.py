"""results.json persistence: the JSON half of ``deepfm_tpu/utils/io.py``.

results.json keeps the reference comparison-harness contract (reference:
deepfm/training/trainer.py:171-195, deepfm/utils/io.py:9-26). The JAX
package's Orbax checkpoints are not ported: the port's checkpoints are
``torch.save`` files (``training/persistence.py``).
"""

from __future__ import annotations

import json
from pathlib import Path


def save_results(results: dict, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2, default=str)
