"""The benchmark's own machinery: the spec reader, the timed window, the
profiled-step reader, the comparison arithmetic and the table of peaks.
Nothing here imports the program; the configurations' ``system.py``
files do."""
