"""The val loader (counterpart of the single-pass val use of the JAX
package's ``data/build.py:DataLoader``): batches in dataset order,
collated on the calling thread. The last batch may be short; the JAX loader
pads it to a fixed shape and reads only its first ``n_valid`` images, so
the metrics are the same."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

from .augment import collate


class ValLoader:
    """One pass over ``dataset`` in order, ``batch_size`` samples a batch."""

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = max(int(batch_size), 1)

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for b0 in range(0, len(self.dataset), self.batch_size):
            stop = min(b0 + self.batch_size, len(self.dataset))
            yield collate([self.dataset[i] for i in range(b0, stop)])
