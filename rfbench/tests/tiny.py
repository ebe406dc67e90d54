"""Small sizes of the measured cells, for runs on the CPU."""

from rfbench import harness

TINY = {"flagship_rx": ({"channels": 8}, {"block": 16384}),
        "channelizer_4096": ({"num_channels": 64}, {"block": 4096})}


def tiny(cell_name: str):
    """(cell, sizes) of ``cell_name`` at a size a CPU test run holds."""
    cell = harness.load_cell(cell_name)
    sizes = harness.load_sizes(cell["config"])
    s, c = TINY[cell["config"]]
    sizes.update(s)
    cell.update(c, warm_blocks=2, trace_blocks=4)
    return cell, sizes


def run_tiny(cell_name: str, seed: int = 12345, seconds: float = 0.3, trace: bool = False):
    cell, sizes = tiny(cell_name)
    return harness.run_cell(cell_name, seed, seconds, trace, device="cpu", cell=cell, sizes=sizes)
