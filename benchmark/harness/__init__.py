"""The benchmark's general machinery: the manifest, the traffic
generator, the window, the trace and the check.  Nothing here imports the
program at module level."""
