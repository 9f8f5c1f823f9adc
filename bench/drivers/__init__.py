"""How a cell drives the program: ``engine`` (``PVQEngine.run`` under open-loop
traffic) and ``batch`` (``serve.generate`` calls back to back).  A cell
names its driver; a new cell on an existing driver adds data files only."""
