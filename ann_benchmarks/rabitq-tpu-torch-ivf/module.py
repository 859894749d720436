"""ann-benchmarks wrapper for the rabitq_tpu_torch IVF index (the PyTorch/CUDA
port), beside the JAX package's ``rabitq-tpu-ivf`` module.

Same BaseANN surface as the reference template
(``ann_benchmarks_templates/rabitq-ivf/module.py``). ``index_params`` may
name a ``device`` ("cpu"); the default is the card.
"""

import numpy as np

from rabitq_tpu_torch.bindings import IvfRabitqIndex


class RabitqTorchIvf:
    def __init__(self, metric, index_params):
        self.metric = metric
        self.index_params = dict(index_params)
        self.nlist = self.index_params.pop("nlist", 1024)
        self.total_bits = self.index_params.pop("total_bits", 7)
        self.device = self.index_params.pop("device", None)
        self.nprobe = 64
        self.index = None
        self._batch_results = None
        self.name = f"IVF-TORCH-L{self.nlist}-B{self.total_bits}"

    def fit(self, X):
        X = np.ascontiguousarray(np.asarray(X), dtype=np.float32)
        n, d = X.shape
        self.index = IvfRabitqIndex(d, metric=self.metric, device=self.device)
        self.index.fit(X, nlist=self.nlist, total_bits=self.total_bits, **self.index_params)

    def set_query_arguments(self, nprobe):
        self.nprobe = int(nprobe if not isinstance(nprobe, dict) else nprobe.get("nprobe", 64))

    def query(self, v, n):
        res = self.index.query(np.asarray(v, np.float32), n, self.nprobe)
        return res[:, 0].astype(np.int64)

    def batch_query(self, X, n):
        res = self.index.batch_query(np.asarray(X, np.float32), n, self.nprobe)
        self._batch_results = [r[:, 0].astype(np.int64) for r in res]

    def get_batch_results(self):
        return self._batch_results

    def __str__(self):
        return f"{self.name}-nprobe{self.nprobe}"
