"""The online model lifecycle: versioned snapshots, hot swap, retraining
and drift detection.

Counterpart of ``avenir_tpu/lifecycle/`` (without the boosted-forest
retrain wave, which waits for boost's serving tables). The reference
splits batch (MapReduce) from online (Storm) and bridges them by hand:
retrain offline, copy the model file, restart the topology. Here:

- ``registry``: a versioned, file-backed snapshot store (monotonic
  versions, manifest JSON, atomic publish, ``latest``, ``get``,
  ``subscribe``), file for file the JAX package's;
- ``retrain``: ``RetrainDaemon``, retrain waves beside a live engine,
  published to the registry;
- ``swap``: the hot-swap seam, a snapshot installed at a batch boundary
  as a stop, restore and resume would;
- ``drift``: Page-Hinkley and windowed-mean detectors over the reward
  stream that request a retrain or count an alarm.
"""

from avenir_tpu_torch.lifecycle.registry import (     # noqa: F401
    RegistryWatcher, Snapshot, SnapshotRegistry, state_schema_hash)
from avenir_tpu_torch.lifecycle.retrain import (      # noqa: F401
    RetrainDaemon, bandit_refit_train_fn)
from avenir_tpu_torch.lifecycle.swap import (         # noqa: F401
    LifecycleClient, install_state)
from avenir_tpu_torch.lifecycle.drift import (        # noqa: F401
    DriftMonitor, PageHinkley, WindowedMeanDetector)
