"""The benchmark's general code: it finds each cell's configuration,
traffic mix, limits and metric readers by name (manifest.py), makes the
inputs and weights from the seed (inputs.py), runs the cell's driver
(perfbench/drivers/<driver>.py), reads the device trace (trace.py) and
prints the result (cell.py)."""
