"""The state surface every optimizer of the port shares: a step ``count``
and, per parameter, the tensors named in ``STATE`` (AdamW's ``mu`` and
``nu``, Adagrad's ``sum_of_squares``, SGD's ``trace``), saved and restored
by parameter name.

``load_state_dict`` copies into the tensors the optimizer already holds and
never rebinds them: B4's pointer table and every captured CUDA graph keep
the addresses they were built with, so a restore must leave every address
as it was.
"""

from typing import Any, Dict, Optional, Sequence

import torch


class StatefulOptimizer:
    """Mixin: ``self.params``, ``self.names`` (one per parameter, from
    ``named_parameters()``), ``self.count`` and, for each name in
    ``STATE``, a list of tensors beside ``self.params``. A step is
    ``prepare(lr)``, ``apply(grads, skip)`` and ``commit(updated)``."""

    STATE = ()

    def _init_names(self, names: Optional[Sequence[str]]):
        self.names = (list(names) if names is not None
                      else [str(i) for i in range(len(self.params))])
        if len(self.names) != len(self.params):
            raise ValueError(f"{len(self.names)} names for "
                             f"{len(self.params)} parameters")

    def _lr_now(self, lr=None) -> float:
        """The lr of the next step: ``lr`` when given (an override), else
        the schedule at the current count, or the constant."""
        if lr is None:
            lr = self.lr(self.count) if callable(self.lr) else self.lr
        return float(lr)

    def commit(self, updated: bool = True):
        if updated:
            self.count += 1

    def step(self, grads):
        self.prepare()
        self.apply(grads)
        self.commit()

    def state_dict(self) -> Dict[str, Any]:
        """``{"count": int, "state": {name: {key: tensor}}}``; the tensors
        are the live ones (a checkpoint engine copies them)."""
        return {"count": self.count,
                "state": {name: {key: getattr(self, key)[i]
                                 for key in self.STATE}
                          for i, name in enumerate(self.names)}}

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, Any]):
        """Copy ``sd`` (a ``state_dict()``, maybe of host tensors) into this
        optimizer's tensors in place; raises on a missing or unknown name,
        a missing key or a shape that differs."""
        state = sd["state"]
        missing = [n for n in self.names if n not in state]
        unknown = [n for n in state if n not in set(self.names)]
        if missing or unknown:
            raise KeyError(f"optimizer state: missing {missing}, "
                           f"unknown {unknown}")
        for i, name in enumerate(self.names):
            for key in self.STATE:
                dst, src = getattr(self, key)[i], state[name][key]
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"optimizer state {name}.{key}: shape "
                        f"{tuple(src.shape)}, want {tuple(dst.shape)}")
                dst.copy_(src)
        self.count = int(sd["count"])
