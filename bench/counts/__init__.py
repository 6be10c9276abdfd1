"""The yardstick's fixed arithmetic: the H100's published peaks, the
operations and bytes an algorithm needs, and which device operations
belong to which layer.  None of it reads the program: a change to the
program moves the time, never the count."""
