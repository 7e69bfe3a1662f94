"""The benchmark's inputs: the frozen scene and the traffic generator.
Nothing here imports the program."""
