"""The systems under test, one module a system, named by a
configuration's ``system`` key. A module maps each entry a traffic mix
can name to a class built as ``Entry(config, plan, seed, device)``: set-up
makes the inputs from the seed on ``device`` and builds the program.
An entry has

- ``samples_per_call``: input samples one call consumes;
- ``call(i)``: call ``i`` through the program, returning its outputs
  without synchronising;
- ``control(i)``: the same outputs from the float64 reference fed TF32
  inputs, in the program's place (the control of ``correct``);
- ``release()``: drop the program and its state;
- ``check(kept)``: the gaps between the kept outputs ({call: outputs})
  and the float64 reference: {number's name: {call: gap}};
- ``work()``: the (bytes, operations) of one call, by the name of the
  roofline that reads it;
- optionally ``yardstick()``: a line for readers, printed by traced runs.
- optionally ``setup_marks``: (stage, seconds) of its set-up, logged by
  every run.
"""
