"""Shared helpers for the parity tests of the PyTorch port (``repro_torch``)
against the JAX reference package (``repro``)."""

#: the reference's backend names that the port renames (reference → port);
#: every other backend name is shared
_PORT_NAME = {"pallas": "kernel"}
_REF_NAME = {port: ref for ref, port in _PORT_NAME.items()}


def port_backend(ref_name: str) -> str:
    """The port's name for a reference backend (``pallas`` → ``kernel``)."""
    return _PORT_NAME.get(ref_name, ref_name)


def ref_backend(port_name: str) -> str:
    """The reference's name for a port backend (``kernel`` → ``pallas``)."""
    return _REF_NAME.get(port_name, port_name)
