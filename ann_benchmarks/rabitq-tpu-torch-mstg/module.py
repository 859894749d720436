"""ann-benchmarks wrapper for the rabitq_tpu_torch MSTG index (the PyTorch/CUDA
port), beside the JAX package's ``rabitq-tpu-mstg`` module.

Same BaseANN surface as the reference template
(``ann_benchmarks_templates/rabitq-mstg/module.py``), on the binding-parity
API (``rabitq_tpu_torch.bindings``). ``index_params`` may name a ``device``
("cpu"); the default is the card.
"""

import numpy as np

from rabitq_tpu_torch.bindings import MstgIndex


class RabitqTorchMstg:
    def __init__(self, metric, index_params):
        self.metric = metric
        self.index_params = dict(index_params)
        self.device = self.index_params.pop("device", None)
        self.index = None
        self._batch_results = None
        parts = []
        if "max_posting_size" in self.index_params:
            parts.append(f"P{self.index_params['max_posting_size']}")
        if "rabitq_bits" in self.index_params:
            parts.append(f"B{self.index_params['rabitq_bits']}")
        self.name = "MSTG-TORCH-" + ("-".join(parts) or "default")

    def fit(self, X):
        X = np.ascontiguousarray(np.asarray(X), dtype=np.float32)
        n, d = X.shape
        self.index = MstgIndex(
            dimension=d, metric=self.metric, device=self.device, **self.index_params
        )
        self.index.fit(X)

    def set_query_arguments(self, query_params):
        if isinstance(query_params, dict):
            self.index.set_query_arguments(
                ef_search=query_params.get("ef_search"),
                pruning_epsilon=query_params.get("pruning_epsilon"),
            )
        else:  # ann-benchmarks sometimes passes a scalar ef
            self.index.set_query_arguments(ef_search=int(query_params))

    def query(self, v, n):
        res = self.index.query(np.asarray(v, np.float32), n)
        return res[:, 0].astype(np.int64)

    def batch_query(self, X, n):
        res = self.index.batch_query(np.asarray(X, np.float32), n)
        self._batch_results = [r[:, 0].astype(np.int64) for r in res]

    def get_batch_results(self):
        return self._batch_results

    def get_memory_usage(self):
        return self.index.get_memory_usage() // 1024 if self.index else 0

    def __str__(self):
        return self.name
