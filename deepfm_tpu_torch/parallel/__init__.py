"""Device-mesh settings of the port (``parallel/mesh.py``): the ``mesh``
section resolved and checked by the JAX package's rules. The port drives
one device; the multi-device runtime is ROADMAP queue 1 item 10."""

from deepfm_tpu_torch.parallel.mesh import (
    check_multihost,
    multiprocess_env_configured,
    resolve_mesh,
)

__all__ = ["check_multihost", "multiprocess_env_configured", "resolve_mesh"]
