"""Drivers by name: how a traffic mix feeds the program.  ``<name>.py`` gives
the harness the closed-loop passes (``replay``), the traced pass
(``traced_pass``) and the probes its path needs (``make_probes``,
``Probes``); a traffic file's ``"driver"`` names one, ``stereo`` by
default."""
