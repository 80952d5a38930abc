from ns_gls_tpu_torch.models.base import BoundaryDescriptor, SimulationBase  # noqa
from ns_gls_tpu_torch.models.channel import SimulationChannel  # noqa
from ns_gls_tpu_torch.models.cylinder import SimulationCylinder  # noqa
from ns_gls_tpu_torch.models.rotation import SimulationRotation  # noqa
from ns_gls_tpu_torch.models.sphere import SimulationSphere  # noqa

# simulations of the JAX package that the port does not have yet
UNPORTED = ()

PORTED = {
    "cylinder": SimulationCylinder,
    "channel": SimulationChannel,
    "sphere": SimulationSphere,
    "rotation": SimulationRotation,
}


def make_simulation(name: str, dim: int):
    if name in PORTED:
        return PORTED[name](dim)
    if name in UNPORTED:
        raise NotImplementedError(
            f"simulation '{name}' is not ported yet (still to port: "
            f"{', '.join(UNPORTED)}; ported: {', '.join(PORTED)})"
        )
    raise ValueError(f"unknown simulation '{name}'")
