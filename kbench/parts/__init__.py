"""Parts found by name: an operator kind (a configuration's
``operator``), a preconditioner kind (a workload's ``precond.kind``) and
an entry (a workload's ``entry``).  Each module builds the port's object
and, where there is one, its plain reference."""
