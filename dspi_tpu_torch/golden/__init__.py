"""The sample-sequential golden model of the firmware (one stream a
instance) and its exact-integer scalar primitives."""
