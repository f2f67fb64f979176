"""The operations a traffic mix can drive, one module each, found by the
traffic file's ``operation``.  Each module defines ``Operation``:

- ``Operation(traffic, seed)``: set-up; imports the program;
- ``inputs(build, probe)``: the program's inputs over one relation pair;
- ``run(inputs)``: one operation through the program's entry, returning
  ``(answer on the host, {phase: seconds} or None)``;
- ``reference(build, probe)`` / ``control(build, probe, seed)``: the plain
  answer and the control's;
- ``LIMITS``: ``{check: limit}``; ``compare(answer, want)`` gives
  ``{check: number}`` for one answer;
- ``compulsory_bytes(build, probe)``: ``bytes.py``'s model of one operation;
- ``trace_extras(inputs)``: host spans the traced run adds (may be empty).
"""
