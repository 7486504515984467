"""The program's side of a cell: each configuration's ``adapter`` names a
module here that builds the system under test from the benchmark's
inputs. These modules, and only these, import the program."""
