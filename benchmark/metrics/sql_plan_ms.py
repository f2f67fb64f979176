"""Host ms of ``sql.plan_sql(statement, tables)``: lexing, parsing, lowering
and rule choice, the mean of the calls the traced run times."""


def read(ctx):
    return ctx.extra.get("sql_plan_ms")
