from ns_gls_tpu_torch.models.base import BoundaryDescriptor, SimulationBase  # noqa
from ns_gls_tpu_torch.models.channel import SimulationChannel  # noqa
from ns_gls_tpu_torch.models.cylinder import SimulationCylinder  # noqa

# simulations of the JAX package that the port does not have yet
UNPORTED = ("rotation", "sphere")


def make_simulation(name: str, dim: int):
    if name == "cylinder":
        return SimulationCylinder(dim)
    if name == "channel":
        return SimulationChannel(dim)
    if name in UNPORTED:
        raise NotImplementedError(
            f"simulation '{name}' is not ported yet (still to port: "
            f"{', '.join(UNPORTED)}; ported: cylinder, channel)"
        )
    raise ValueError(f"unknown simulation '{name}'")
