"""Plan data types of the port (`InferencePlan`, `OpChoice`)."""
