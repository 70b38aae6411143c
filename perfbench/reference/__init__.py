"""Plain fp32 references, one module a family (``<family>.py``), each with
a ``MODEL`` class; they import nothing of the program."""
