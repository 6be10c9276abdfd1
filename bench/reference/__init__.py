"""Plain f32 references of the configurations' model families, one module
a family (``dense``, ``moe``), over the SKVQ cache written out in
:mod:`reference.skvq`.  They import nothing of the program."""
