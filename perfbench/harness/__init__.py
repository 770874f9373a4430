"""The benchmark's general machinery: it finds a cell's configuration,
traffic and metric readers by name (``spec``), sets up and times the jobs
(``jobs``), reduces a profiler trace (``trace``), judges the outputs
against the plain reference (``check``) and prints the result line
(``main``).  Nothing here names a cell, a configuration or a traffic mix."""
