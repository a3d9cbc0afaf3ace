"""Elastic training: commit and rollback of state, host discovery, and the
in-process re-form of the gang.  The port of ``horovod_tpu.elastic``.

``@hvd.elastic.run`` wraps a training function whose first argument is a
:class:`State`; when a rank fails or the host set changes, the gang
re-forms in process at the next membership epoch, the state rolls back to
its last ``commit()`` and re-syncs from the new rank 0, and the function
runs again.  ``KerasState`` holds a Keras model's weights.
"""

from horovod_tpu_torch.elastic.driver import (  # noqa: F401
    ElasticDriver,
    FixedHostDiscovery,
    HostDiscoveryScript,
    HostsUpdatedInterrupt,
)
from horovod_tpu_torch.elastic.run import (  # noqa: F401
    last_group_error,
    last_replay_results,
    run,
)
from horovod_tpu_torch.elastic.state import (  # noqa: F401
    KerasState,
    ObjectState,
    State,
    TorchState,
)
